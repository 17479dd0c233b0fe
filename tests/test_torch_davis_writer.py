"""The DAVIS writer's pipeline (``inference/output_utils/davis.py``) against
a serial oracle kept here: per frame the mask resize, the Python condense
loop (later kept ids overwrite), one PIL save, and the overlay of each
index on the frame for ``save_visualization``.

* CPU: PNGs and JPEGs byte-equal to the oracle's over random label volumes
  (0, 1 and 20 kept tracks; 480x854 and an odd size; labels at the
  network's output scale and at its input scale); ``condense`` equal to
  the loop on overlapping masks; a failed save raised from
  ``process_sequence`` (the first failed frame's, in frame order) once
  every other frame is written; ``writer.pooled_frames`` counts the frames
  written under a profiler session.
* On a card (``card``): the CUDA path's PNGs equal the CPU path's over a
  104-frame volume at DAVIS's dims, and the number of synchronising calls
  does not grow with the frames.

No JAX: this file runs on the card too
(``STEMSEG_TEST_TPU=1 python -m pytest tests/test_torch_davis_writer.py``).
"""

import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from stemseg_tpu_torch.inference.chainer import OUTLIER_LABEL
from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
from stemseg_tpu_torch.inference.output_utils.common import (
    masks_to_original_dims,
    select_instances_to_keep,
)
from stemseg_tpu_torch.inference.output_utils.davis import condense
from stemseg_tpu_torch.structures.geometry import compute_resize_params, pad_to_multiple
from stemseg_tpu_torch.utils import profiling
from stemseg_tpu_torch.utils.vis import create_color_map, overlay_mask_on_image

torch.set_num_threads(2)

T = 4
MIN_DIM, MAX_DIM = 240, 432  # narrower than DAVIS's 736 / 1248, for the CPU
SIZES = {"davis": (480, 854), "odd": (97, 131)}


class Seq:
    def __init__(self, seq_id, hw, frames=None):
        self.id, self.image_dims, self._frames = seq_id, hw, frames

    def load_images(self):
        return list(self._frames)


def volume(n_frames, hw, upscaled, n_ids, seed, min_dim=MIN_DIM, max_dim=MAX_DIM):
    """Blocky random labels of ``n_ids`` tracks and outliers at the scale the
    writer reads, and distinct lifetimes (so the kept order is fixed)."""
    w, h, _ = compute_resize_params(hw[::-1], min_dim, max_dim)
    ph, pw = pad_to_multiple(h, w)
    lh, lw = (ph, pw) if upscaled else (ph // 4, pw // 4)
    block = 24 if upscaled else 6
    rng = np.random.RandomState(seed)
    cells = rng.randint(-1, n_ids, (n_frames, -(-lh // block), -(-lw // block)))
    labels = cells.repeat(block, 1).repeat(block, 2)[:, :lh, :lw].astype(np.int32)
    lifetimes = {OUTLIER_LABEL: n_frames + 100}
    lifetimes.update({i: int(v) for i, v in enumerate(rng.permutation(n_ids) + 1)})
    return np.ascontiguousarray(labels), lifetimes


def oracle(out_dir, seq, labels, lifetimes, max_tracks, upscaled, frames,
           min_dim=MIN_DIM, max_dim=MAX_DIM):
    """The serial writer: resize, condense loop, PIL save, overlays."""
    import cv2

    kept = select_instances_to_keep(lifetimes, OUTLIER_LABEL, max_tracks)
    cmap = create_color_map()
    labels_t = torch.from_numpy(labels)
    kept_t = torch.tensor(kept, dtype=labels_t.dtype).view(-1, 1, 1)
    res_dir = os.path.join(out_dir, "results", seq.id)
    vis_dir = os.path.join(out_dir, "vis", seq.id)
    os.makedirs(res_dir)
    os.makedirs(vis_dir)
    for t in range(len(labels)):
        condensed = np.zeros(seq.image_dims, np.uint8)
        if kept:
            full = masks_to_original_dims(labels_t[t][None] == kept_t, 4, seq.image_dims,
                                          min_dim, max_dim, upscaled).numpy()
            for n in range(len(kept)):
                condensed[full[n]] = n + 1
        img = Image.fromarray(condensed)
        img.putpalette(cmap.flatten())
        img.save(os.path.join(res_dir, f"{t:05d}.png"))
        if frames is not None:
            image = frames[t]
            for n in sorted(set(np.unique(condensed)) - {0}):
                image = overlay_mask_on_image(image, condensed == n, mask_color=cmap[n])
            cv2.imwrite(os.path.join(vis_dir, f"{t:05d}.jpg"), image)
    return kept


def files(out_dir, sub, seq_id):
    d = os.path.join(out_dir, sub, seq_id)
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def write(writer, seq, labels, lifetimes, max_tracks, min_dim=MIN_DIM, max_dim=MAX_DIM):
    return writer.process_sequence(seq, labels, {}, lifetimes, None, mask_scale=4,
                                   max_tracks=max_tracks, min_dim=min_dim, max_dim=max_dim)


@pytest.mark.parametrize("upscaled", [False, True], ids=["output_scale", "input_scale"])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("k", [0, 1, 20])
def test_pngs_and_vis_equal_the_serial_oracle(tmp_path, k, size, upscaled):
    hw = SIZES[size]
    labels, lifetimes = volume(T, hw, upscaled, k + 3, seed=k * 10 + len(size))
    frames = (np.random.RandomState(k).rand(T, *hw, 3) * 255).astype(np.uint8)
    seq = Seq("s", hw, frames)
    want = oracle(str(tmp_path / "oracle"), seq, labels, lifetimes, k, upscaled, frames)
    writer = DavisOutputGenerator(str(tmp_path / "port"), upscaled_inputs=upscaled,
                                  save_visualization=True, device="cpu")
    assert write(writer, seq, labels, lifetimes, k) == want and len(want) == k
    pngs = files(tmp_path / "port", "results", "s")
    assert list(pngs) == [f"{t:05d}.png" for t in range(T)]
    assert pngs == files(tmp_path / "oracle", "results", "s")
    assert files(tmp_path / "port", "vis", "s") == files(tmp_path / "oracle", "vis", "s")
    ids = set()
    for t in range(T):
        ids |= set(np.unique(np.asarray(Image.open(tmp_path / "port" / "results" / "s"
                                                   / f"{t:05d}.png"))).tolist())
    assert ids == set(range(k + 1))  # every kept track shows


@pytest.mark.parametrize("k", [1, 2, 20, 255])
def test_condense_lets_later_masks_overwrite(k):
    masks = torch.from_numpy(np.random.RandomState(k).rand(k, 13, 17) > 0.5)
    want = np.zeros((13, 17), np.uint8)
    for n in range(k):
        want[masks[n].numpy()] = n + 1
    got = condense(masks)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_failed_save_is_raised_once_the_other_frames_are_written(tmp_path, monkeypatch):
    hw, n = SIZES["odd"], 6
    labels, lifetimes = volume(n, hw, False, 5, seed=4)
    seq = Seq("s", hw)
    oracle(str(tmp_path / "oracle"), seq, labels, lifetimes, 3, False, None)
    real = Image.Image.save

    def failing(self, fp, *args, **kwargs):
        for t in (1, 3):
            if str(fp).endswith(f"{t:05d}.png"):
                raise OSError(f"frame {t} failed")
        return real(self, fp, *args, **kwargs)

    monkeypatch.setattr(Image.Image, "save", failing)
    writer = DavisOutputGenerator(str(tmp_path / "port"), device="cpu")
    with pytest.raises(OSError, match="frame 1 failed"):
        write(writer, seq, labels, lifetimes, 3)
    want = files(tmp_path / "oracle", "results", "s")
    assert files(tmp_path / "port", "results", "s") == {
        name: data for name, data in want.items() if name not in ("00001.png", "00003.png")}


def test_pooled_frames_counts_the_frames_written(tmp_path):
    writer = DavisOutputGenerator(str(tmp_path), device="cpu")
    hw = SIZES["odd"]
    with profile(activities=[ProfilerActivity.CPU]):
        for seq_id, n, k in (("a", 3, 2), ("b", 5, 0)):
            labels, lifetimes = volume(n, hw, False, k + 1, seed=n)
            write(writer, Seq(seq_id, hw), labels, lifetimes, k)
    records = profiling.last_session()
    written = sum(len(os.listdir(tmp_path / "results" / s)) for s in ("a", "b"))
    assert records["counters"] == {"writer.pooled_frames": written} and written == 8


# -- on a card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
def test_card_pngs_equal_the_cpu_pngs_with_no_sync_a_frame(tmp_path, card):
    hw, n, k = SIZES["davis"], 104, 20
    dims = {"min_dim": 736, "max_dim": 1248}  # davis_2's
    labels, lifetimes = volume(n, hw, False, k + 3, seed=17, **dims)
    for device in ("cpu", "cuda"):
        write(DavisOutputGenerator(str(tmp_path / device), device=device), Seq("s", hw),
              labels, lifetimes, k, **dims)
    cuda = files(tmp_path / "cuda", "results", "s")
    assert len(cuda) == n and cuda == files(tmp_path / "cpu", "results", "s")

    syncs = {}
    writer = DavisOutputGenerator(str(tmp_path / "sync"), device="cuda")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for frames in (8, n):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                write(writer, Seq(f"f{frames}", hw), labels[:frames], lifetimes, k, **dims)
            syncs[frames] = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert syncs[8] == syncs[n], syncs  # the labels' upload, not a sync a frame
