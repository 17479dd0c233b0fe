"""The port's host-side helpers against the JAX package's: resize and pad
geometry, the window schedule and the DAVIS palette. All exact."""

import numpy as np
import pytest

from stemseg_tpu.inference.windows import get_subsequence_frames as jax_windows
from stemseg_tpu.structures.geometry import compute_resize_params as jax_resize_params
from stemseg_tpu.structures.geometry import pad_to_multiple as jax_pad_to_multiple
from stemseg_tpu.utils.vis import create_color_map as jax_color_map
from stemseg_tpu_torch.inference.windows import get_subsequence_frames
from stemseg_tpu_torch.structures.geometry import compute_resize_params, pad_to_multiple
from stemseg_tpu_torch.utils.vis import create_color_map


@pytest.mark.parametrize("image_dims,min_dim,max_dim", [
    ((854, 480), 736, 1248),   # DAVIS frame, davis_2 preset: 1248x701
    ((854, 480), 480, 854),    # DAVIS frame at 480p
    ((1242, 375), 512, 1280),  # KITTI frame: the max dim binds
    ((48, 32), 64, 96),
    ((33, 77), 50, 100),       # portrait, odd sizes
])
def test_resize_and_pad_match_jax(image_dims, min_dim, max_dim):
    ours = compute_resize_params(image_dims, min_dim, max_dim)
    assert ours == jax_resize_params(image_dims, min_dim, max_dim)
    new_w, new_h, _ = ours
    assert pad_to_multiple(new_h, new_w) == jax_pad_to_multiple(new_h, new_w)


@pytest.mark.parametrize("seq_len,subseq_len,overlap", [
    (26, 16, 6), (16, 8, 6), (10, 4, 2), (69, 8, 6), (8, 8, 6), (5, 8, 6), (1, 16, 6),
])
def test_window_schedule_matches_jax(seq_len, subseq_len, overlap):
    windows = get_subsequence_frames(seq_len, subseq_len, overlap)
    assert windows == jax_windows(seq_len, subseq_len, overlap)[0]
    assert all(len(w) == subseq_len for w in windows)
    assert sorted({t for w in windows for t in w}) == list(range(seq_len))


def test_window_schedule_rejects_overlap_of_whole_window():
    with pytest.raises(ValueError):
        get_subsequence_frames(20, 8, 8)


def test_color_map_matches_jax():
    np.testing.assert_array_equal(create_color_map(), jax_color_map())
