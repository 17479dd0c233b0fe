"""The port's real-dataset training pipeline (``stemseg_tpu_torch/data/``)
against the JAX package's, on the CPU, with a tolerance of 0: every array
byte-equal. The JAX side draws from the global ``random`` and
``np.random`` after ``random.seed(s); np.random.seed(s)``; the port is
given ``random.Random(s)`` and ``np.random.RandomState(s)``.

Datasets: ``chip_smoke.write_training_datasets`` at 40x56 frames (each
dataset's own layout and JSON), clips of 4 frames.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo root: its dataset writer)
import stemseg_tpu.data as J
import stemseg_tpu_torch.data as P
from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.data import transforms as jax_transforms
from stemseg_tpu.utils.constants import RepoPaths as JaxRepoPaths
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.data import paths, transforms
from stemseg_tpu_torch.data.image_clip_loaders import load_category_table

torch.set_num_threads(2)

TINY = {"input": {"num_frames": 4, "min_dim": 32, "max_dim": 48}}
TINY_SHAPES = {k: (40, 56) for k in chip_smoke.TRAIN_DATA_SHAPES}
SAMPLE_KEYS = ("images", "masks", "ignore_masks", "category_ids")


@pytest.fixture(scope="module")
def dataset_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    return chip_smoke.write_training_datasets(str(root), seed=0, shapes=TINY_SHAPES)


@pytest.fixture()
def env(dataset_env, monkeypatch):
    for k, v in dataset_env.items():
        monkeypatch.setenv(k, v)
    return dataset_env


def seeded(s):
    """Seed the JAX side's global generators; return the port's pair."""
    random.seed(s)
    np.random.seed(s)
    return random.Random(s), np.random.RandomState(s)


def assert_same_bytes(a, b, tag=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (tag, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), tag


def assert_same_sample(ours, theirs, tag=""):
    assert ours.keys() == theirs.keys(), tag
    for k in SAMPLE_KEYS:
        assert_same_bytes(ours[k], theirs[k], (tag, k))
    assert ours["orig_dims"] == theirs["orig_dims"] and ours["meta"] == theirs["meta"], tag


@pytest.mark.parametrize("name", ["coco", "pascal_voc", "mapillary"])
def test_metainfo_tables_equal_the_jax_yamls(name):
    with open(os.path.join(JaxRepoPaths.dataset_meta_info_dir(), f"{name}.yaml")) as fh:
        want = yaml.safe_load(fh)
    got = load_category_table(name)
    assert got == want and list(got) == list(want)


def test_resize_images_and_mask_match_jax():
    rng = np.random.RandomState(0)
    images = rng.randn(3, 37, 53, 3).astype(np.float32) * 50
    for hw in ((32, 45), (74, 106), (37, 53)):
        assert_same_bytes(transforms.resize_images(images, hw),
                          jax_transforms.resize_images(images, hw), hw)
        for mask in (rng.rand(37, 53) > 0.6, (rng.rand(53, 37) > 0.4).T.astype(np.uint8)):
            assert_same_bytes(transforms.resize_mask(mask, hw),
                              jax_transforms.resize_mask(mask, hw), hw)


def _video_pair(env, which):
    base, vds = {"davis": (paths.DavisUnsupervisedPaths.trainval_base_dir(),
                           paths.DavisUnsupervisedPaths.train_vds_file()),
                 "kitti": (paths.KITTIMOTSPaths.train_images_dir(),
                           paths.KITTIMOTSPaths.train_vds_file())}[which]
    return P.parse_generic_video_dataset(base, vds), J.parse_generic_video_dataset(base, vds)


@pytest.mark.parametrize("which", ["davis", "kitti"])
def test_video_parser_matches_jax(env, which):
    (ours, meta), (theirs, jmeta) = _video_pair(env, which)
    assert meta == jmeta and len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.id, a.image_paths, a.image_dims, a.instance_categories, a.segmentations) == \
            (b.id, b.image_paths, b.image_dims, b.instance_categories, b.segmentations)
        assert a.instance_ids == b.instance_ids and a.category_labels == b.category_labels
        # subsequences, then the category and empty-frame filters
        sa, sb = a.extract_subsequence([1, 5, 9, 17], "sub"), b.extract_subsequence(
            [1, 5, 9, 17], "sub")
        assert (sa.id, sa.image_paths, sa.instance_categories, sa.segmentations) == \
            (sb.id, sb.image_paths, sb.instance_categories, sb.segmentations)
        masks_a, masks_b = sa.load_masks(), sb.load_masks()
        assert len(masks_a) == len(masks_b) == 4
        for ma, mb in zip(masks_a, masks_b):
            for x, y in zip(ma, mb):
                assert x.flags.c_contiguous
                assert_same_bytes(x, y, a.id)
        for x, y in zip(sa.load_images(), sb.load_images()):
            assert_same_bytes(x, y, a.id)
        keep = {2, 3} if which == "kitti" else {1}
        for s in (a, b):
            s.filter_categories(keep)
            s.filter_zero_instance_frames()
        assert (a.image_paths, a.instance_categories, a.segmentations) == \
            (b.image_paths, b.instance_categories, b.segmentations)


def test_video_parser_checks_instance_ids(env, tmp_path):
    with open(paths.DavisUnsupervisedPaths.train_vds_file()) as fh:
        ds = json.load(fh)
    ds["sequences"][1]["categories"]["7"] = 1  # an instance without masks
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as fh:
        json.dump(ds, fh)
    with pytest.raises(AssertionError, match="Instance ID mismatch"):
        J.parse_generic_video_dataset("", bad)
    with pytest.raises(ValueError, match="instance ids"):
        P.parse_generic_video_dataset("", bad)


@pytest.mark.parametrize("which", ["coco", "pascal_voc", "mapillary"])
def test_image_parser_matches_jax(env, which):
    base, ids = {"coco": (paths.CocoPaths.images_dir(), paths.CocoPaths.ids_file()),
                 "pascal_voc": (paths.PascalVOCPaths.images_dir(),
                                paths.PascalVOCPaths.ids_file()),
                 "mapillary": (paths.MapillaryPaths.images_dir(),
                               paths.MapillaryPaths.ids_file())}[which]
    (ours, meta), (theirs, jmeta) = (P.parse_generic_image_dataset(base, ids),
                                     J.parse_generic_image_dataset(base, ids))
    assert meta == jmeta and len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a.path, a.height, a.width, a.categories, a.segmentations, a.ignore) == \
            (b.path, b.height, b.width, b.categories, b.segmentations, b.ignore)
        assert a.mask_areas() == b.mask_areas()
        assert_same_bytes(a.load_image(), b.load_image())
        for x, y in zip(a.load_masks(), b.load_masks()):
            assert_same_bytes(x, y)
        if which == "pascal_voc":
            assert a.ignore is not None
            assert_same_bytes(a.load_ignore_mask(), b.load_ignore_mask())
        else:
            assert a.load_ignore_mask() is None
        for s in (a, b):
            s.filter_categories({1, 20, 56})
        assert (a.categories, a.segmentations) == (b.categories, b.segmentations)


# the augmenter of each image clip loader (the video loaders do not augment)
AUGMENTER_OPTIONS = {
    "coco": (12, 0.25), "pascal_voc": (10, 0.25), "mapillary": (10, 0.0)}


@pytest.mark.parametrize("option", list(AUGMENTER_OPTIONS))
def test_augmenter_matches_jax(option):
    rotation, blur_prob = AUGMENTER_OPTIONS[option]
    ours = P.ImageToSeqAugmenter(rotation, motion_blur_prob=blur_prob)
    theirs = J.ImageToSeqAugmenter(
        perspective=True, affine=True, motion_blur=True, rotation_range=(-rotation, rotation),
        perspective_magnitude=0.08, hue_saturation_range=(-5, 5), brightness_range=(-40, 40),
        motion_blur_prob=blur_prob, motion_blur_kernel_sizes=(9, 11),
        translate_range=(-0.1, 0.1))
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (40, 56, 3), np.uint8)
    mask = np.zeros((40, 56), np.uint8)
    mask[8:30, 12:40] = 1
    masks = [mask, np.flip(mask, axis=1), (rng.rand(40, 56) > 0.7).astype(np.uint8)]
    blurred = 0
    for s in range(50):
        prng, pnp = seeded(s)
        want = theirs(image, masks)
        got = ours(image, masks, prng, pnp)
        assert_same_bytes(got[0], want[0], (option, s))
        assert_same_bytes(got[2], want[2], (option, s))
        for x, y in zip(got[1], want[1]):
            assert_same_bytes(x, y, (option, s))
        # the port drew as many values as the JAX package
        assert prng.random() == random.random() and pnp.rand() == np.random.rand()
        blurred += ours._motion_blur(image, seeded(s)[0]) is not image
    assert (blurred > 0) == (blur_prob > 0)


def _frames(n, h=40, w=56, seed=2):
    return [np.random.RandomState(seed + t).randint(0, 256, (h, w, 3), np.uint8)
            for t in range(n)]


def _box_masks(boxes, h=40, w=56):
    masks = []
    for box in boxes:
        m = np.zeros((h, w), np.uint8)
        if box is not None:
            x0, y0, x1, y1 = box
            m[y0:y1, x0:x1] = 1
            m[y0, x0] = 0  # not a plain box, so that a flip shows
        masks.append(m)
    return masks


DUPLICATOR_CASES = {
    "free": [(20, 10, 30, 20), (21, 11, 31, 21), (22, 12, 32, 22)],
    "touches_left_and_right": [(0, 10, 10, 20), (46, 10, 56, 20), (20, 10, 30, 20)],
    "wide_at_left": [(0, 10, 30, 20)] * 3,
    "wide_at_right": [(26, 10, 56, 20)] * 3,
    "narrow_near_left": [(2, 15, 8, 25)] * 3,
    "narrow_near_right": [(48, 15, 54, 25)] * 3,
    "tall_at_top": [(20, 0, 30, 25)] * 3,
    "tall_at_bottom": [(20, 15, 30, 40)] * 3,
    "short_near_top": [(20, 2, 30, 7), (20, 3, 30, 8), (20, 2, 30, 7)],
    "short_near_bottom": [(20, 33, 30, 38)] * 3,
    "touches_top_and_bottom": [(20, 0, 30, 10), (20, 30, 30, 40), (20, 10, 30, 20)],
    "empty_frame": [(20, 10, 30, 20), None, (22, 12, 32, 22)],
    "all_empty": [None, None, None],
}


@pytest.mark.parametrize("case", list(DUPLICATOR_CASES) + ["shape_mismatch"])
def test_instance_duplicator_matches_jax(case, capsys):
    images = _frames(3)
    if case == "shape_mismatch":
        masks = _box_masks(DUPLICATOR_CASES["free"])
        masks[1] = masks[1][:, :50]
    else:
        masks = _box_masks(DUPLICATOR_CASES[case])
    outcomes = set()
    for s in range(8):
        prng, _ = seeded(s)
        want_images, want_masks = J.InstanceDuplicator()(images, masks)
        got_images, got_masks = P.InstanceDuplicator()(images, masks, prng)
        assert prng.random() == random.random()
        outcomes.add(got_images is None)
        if want_images is None:
            assert got_images is None and got_masks is None
            continue
        for x, y in zip(got_images, want_images):
            assert_same_bytes(x, y, (case, s))
        for part in range(2):
            for x, y in zip(got_masks[part], want_masks[part]):
                assert_same_bytes(x, y, (case, s, part))
    declined = case in ("touches_left_and_right", "shape_mismatch")
    assert outcomes == {declined}
    if case == "shape_mismatch":
        assert "Exception occurred" in capsys.readouterr().out


# what the port's loaders fix and the JAX loaders take as an argument
JAX_FIXED = {"davis": dict(single_instance_duplication=True)}


def _loader_pair(name, cfg_over=None, **kwargs):
    """(port loader, JAX loader), built from the same construction seed."""
    over = json.loads(json.dumps(TINY))
    for k, v in (cfg_over or {}).items():
        over["input"][k] = v
    icfg, jicfg = load_config(over).input, jax_load_config(over).input
    image_sets = {"coco": ("CocoDataLoader", paths.CocoPaths),
                  "pascal_voc": ("PascalVOCDataLoader", paths.PascalVOCPaths),
                  "mapillary": ("MapillaryDataLoader", paths.MapillaryPaths)}
    if name in image_sets:
        cls, where = image_sets[name]
        args = (where.images_dir(), where.ids_file())
        return (getattr(P, cls)(*args, icfg, **kwargs), getattr(J, cls)(*args, jicfg, **kwargs))
    cls, where, base = {
        "davis": ("DavisDataLoader", paths.DavisUnsupervisedPaths, "trainval_base_dir"),
        "youtube_vis": ("YoutubeVISDataLoader", paths.YoutubeVISPaths, "training_base_dir"),
        "kitti_mots": ("MOTSDataLoader", paths.KITTIMOTSPaths, "train_images_dir")}[name]
    args = (getattr(where, base)(), where.train_vds_file())
    ours = getattr(P, cls)(*args, icfg, 12, random.Random(7), **kwargs)
    random.seed(7)
    theirs = getattr(J, cls)(*args, jicfg, 12, **kwargs, **JAX_FIXED.get(name, {}))
    assert [(s.id, s.image_paths, s.instance_categories, s.segmentations)
            for s in ours.samples] == [(s.id, s.image_paths, s.instance_categories,
                                        s.segmentations) for s in theirs.samples]
    return ours, theirs


GAPS_16 = dict(frame_gap_lower=16, frame_gap_upper=16)
GAPS_8 = dict(frame_gap_lower=8, frame_gap_upper=8)
LOADER_CASES = {
    "coco_davis": ("coco", {}, dict(category_agnostic=True)),
    "coco_ytvis": ("coco", {}, dict(category_agnostic=False)),
    "pascal_voc_davis": ("pascal_voc", {}, dict(category_agnostic=True)),
    "pascal_voc_ytvis": ("pascal_voc", {}, dict(category_agnostic=False)),
    "mapillary": ("mapillary", {"num_classes": 3}, {}),
    "davis": ("davis", {}, GAPS_16),
    "davis_gaps_10_to_14": ("davis", {}, dict(frame_gap_lower=10, frame_gap_upper=14)),
    "youtube_vis_agnostic": ("youtube_vis", {}, dict(GAPS_8, category_agnostic=True,
                                                     single_instance_duplication=True)),
    "youtube_vis_classes": ("youtube_vis", {}, dict(GAPS_8, category_agnostic=False,
                                                    single_instance_duplication=True)),
    "youtube_vis_no_duplication": ("youtube_vis", {}, dict(GAPS_8, category_agnostic=True,
                                                           single_instance_duplication=False)),
    "kitti_mots": ("kitti_mots", {"max_dim": 64}, GAPS_8),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_samples_match_jax(env, case):
    name, cfg_over, kwargs = LOADER_CASES[case]
    ours, theirs = _loader_pair(name, cfg_over, **kwargs)
    assert len(ours) == len(theirs) >= 3
    for i in range(8):
        idx = i % len(ours)
        prng, pnp = seeded(1000 + i)
        theirs_sample = theirs[idx]
        ours_sample = ours.get(idx, prng, pnp)
        assert_same_sample(ours_sample, theirs_sample, (case, i))
        assert prng.random() == random.random() and pnp.rand() == np.random.rand()


def test_loaders_exercise_their_branches(env):
    """The fixtures reach what the loaders exist for: Mapillary keeps its 30
    largest cars and persons of more than 30 and ignores the rest, VOC drops
    instances under 50 pixels and reads its ignore RLE, MOTS splits at the
    gap and turns category 3 into the ignore mask, DAVIS duplicates single
    instances."""
    mapillary, _ = _loader_pair("mapillary", {"num_classes": 3})
    kept = [sum(c in mapillary.cat_ids_to_keep for c in s.categories)
            for s in mapillary.samples]
    assert max(kept) > 30
    crowded = mapillary.samples[kept.index(max(kept))]
    areas = crowded.mask_areas()
    order = sorted(range(len(areas)), key=lambda i: areas[i], reverse=True)
    in_top_30 = sum(crowded.categories[i] in mapillary.cat_ids_to_keep for i in order[:30])
    sample = mapillary.get(kept.index(max(kept)), *seeded(0))
    assert sample["masks"].shape[0] == in_top_30 < max(kept)
    assert set(sample["category_ids"]) == {1, 2} and sample["ignore_masks"].any()

    voc, _ = _loader_pair("pascal_voc", category_agnostic=True)
    raw, _ = P.parse_generic_image_dataset(paths.PascalVOCPaths.images_dir(),
                                           paths.PascalVOCPaths.ids_file())
    assert sum(len(s.segmentations) for s in voc.samples) < \
        sum(len(s.segmentations) for s in raw)
    assert min(a for s in voc.samples for a in s.mask_areas()) >= 50

    mots, _ = _loader_pair("kitti_mots", **GAPS_8)
    assert sorted(s.id for s in mots.sequences) == ["0000_1", "0000_2", "0001_1"]
    with_ignore = [i for i, s in enumerate(mots.samples) if 3 in s.category_labels]
    assert with_ignore
    sample = mots.get(with_ignore[0], *seeded(0))
    assert 3 not in sample["category_ids"] and sample["ignore_masks"].any()

    davis, _ = _loader_pair("davis", **GAPS_16)
    single = [i for i, s in enumerate(davis.samples) if len(s.instance_ids) == 1]
    assert single
    assert davis.get(single[0], *seeded(0))["masks"].shape[0] == 2


class _Fake:
    def __init__(self, n, tag):
        self.n, self.tag = n, tag

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.tag, i

    def get(self, i, rng, np_rng):
        return self.tag, i, rng.random(), np_rng.rand()


@pytest.mark.parametrize("mode,lengths,total", [
    ("davis", (120, 3, 40, 70), 100), ("davis", (7, 50, 30, 2), 20),
    ("youtube_vis", (90, 5, 300), 50), ("youtube_vis", (4, 60, 8), 10),
    ("kitti_mots_1", (12,), 40), ("kitti_mots_2", (33,), 40),
    ("kitti_mots_both", (13, 40), 30)])
def test_concat_dataset_matches_jax(mode, lengths, total):
    weights = {"davis": [0.25, 0.35, 0.3, 0.1], "youtube_vis": [0.3, 0.1, 0.6],
               "kitti_mots_1": [1.0], "kitti_mots_2": [1.0],
               "kitti_mots_both": [0.5, 0.5]}[mode]
    datasets = [_Fake(n, i) for i, n in enumerate(lengths)]
    ours = P.ConcatDataset(datasets, total, weights, seed=3)
    theirs = J.ConcatDataset(datasets, total, weights)
    assert ours.id_mapping == theirs.id_mapping and len(ours) == total
    assert ours.samples_per_dataset == theirs.samples_per_dataset
    for a, b in zip(ours.datasets, theirs.datasets):
        assert type(a).__name__ == type(b).__name__
        if isinstance(a, P.SparseDataset):
            assert a.idxes == b.idxes and len(a) == len(b)
    for i in range(total):
        tag, j, r, n = ours[i]
        assert (tag, j) == theirs[i]
        rng, np_rng = P.sample_generators(3, i)
        assert (r, n) == (rng.random(), np_rng.rand())


def test_concat_dataset_refuses_an_empty_quota():
    with pytest.raises(ValueError, match="gets no sample"):
        P.ConcatDataset([_Fake(5, 0), _Fake(5, 1)], 4, [0.9, 0.1], seed=0)
    with pytest.raises(ZeroDivisionError):
        J.ConcatDataset([_Fake(5, 0), _Fake(5, 1)], 4, [0.9, 0.1])


def test_visualize_data_loading_writes_jpegs(env, tmp_path):
    from stemseg_tpu.data import visualize_data_loading as jax_vdl
    from stemseg_tpu_torch.config import save_config
    from stemseg_tpu_torch.data import visualize_data_loading as vdl

    over = json.loads(json.dumps(TINY))
    over["training"] = {"mode": "davis", "max_iterations": 5}
    cfg_path = str(tmp_path / "cfg.yaml")
    save_config(load_config(over), cfg_path)
    out = tmp_path / "vis"
    vdl.main(["--cfg", cfg_path, "-o", str(out), "--num_samples", "10"])
    assert sorted(os.listdir(out)) == [f"sample_{i:03d}" for i in range(10)]
    for i in range(10):
        assert sorted(os.listdir(out / f"sample_{i:03d}")) == [f"{t:05d}.jpg" for t in range(4)]

    # the rendering itself is the JAX package's, byte for byte
    from stemseg_tpu_torch.training.datasets import create_training_dataset

    cfg = load_config(over)
    sample = create_training_dataset(cfg, 10, seed=vdl.SEED, print_fn=lambda *a: None)[3]
    vdl.render_sample(sample, cfg.input, str(tmp_path / "ours"))
    jax_vdl.render_sample(sample, jax_load_config(over).input, str(tmp_path / "theirs"))
    for t in range(4):
        assert (tmp_path / "ours" / f"{t:05d}.jpg").read_bytes() == \
            (tmp_path / "theirs" / f"{t:05d}.jpg").read_bytes()
        assert (tmp_path / "ours" / f"{t:05d}.jpg").read_bytes() == \
            (out / "sample_003" / f"{t:05d}.jpg").read_bytes()
