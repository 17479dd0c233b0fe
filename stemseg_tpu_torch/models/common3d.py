"""Temporal pooling / upsampling schedules of the 3D decoders, as pure
functions of the clip length."""

from __future__ import annotations

from typing import List


def get_pooling_flags(num_frames: int) -> List[bool]:
    """Which of the decoder's three pooling slots pool temporally (True) and
    which are the identity (False)."""
    if num_frames == 2:
        return [False, False, False]
    if num_frames == 4:
        return [True, False, False]
    if num_frames == 8:
        return [True, True, False]
    if num_frames in (16, 24, 32):
        return [True, True, True]
    raise NotImplementedError(f"No temporal pooling schedule for num_frames={num_frames}")


def get_temporal_scales(num_frames: int) -> List[int]:
    """Per-stage temporal upsample factors of the 32->16->8->4 cascade."""
    if num_frames == 2:
        return [1, 1, 1]
    if num_frames == 4:
        return [1, 1, 2]
    if num_frames == 8:
        return [1, 2, 2]
    if num_frames in (16, 24, 32):
        return [2, 2, 2]
    raise NotImplementedError(f"No temporal scale schedule for num_frames={num_frames}")
