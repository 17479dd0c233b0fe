"""Overlapping-window schedule for videos of any length: fixed-T windows
with overlap (6 for DAVIS) whose tracks the chainer stitches."""

from __future__ import annotations

from typing import List


def get_subsequence_frames(seq_len: int, subseq_len: int,
                           frame_overlap: int) -> List[List[int]]:
    """:return: windows, each a list of ``subseq_len`` frame indices; a
    sequence shorter than that is one window that repeats frame 0 in
    front."""
    if frame_overlap >= subseq_len:
        raise ValueError(f"frame_overlap {frame_overlap} must be < {subseq_len}")

    if seq_len < subseq_len:
        return [[0] * (subseq_len - seq_len) + list(range(seq_len))]

    windows = []
    last_frame_idx = -1
    for t in range(0, seq_len - subseq_len + 1, subseq_len - frame_overlap):
        windows.append(list(range(t, t + subseq_len)))
        last_frame_idx = windows[-1][-1]

    if last_frame_idx != seq_len - 1:
        # tail window anchored to the sequence end
        windows.append(list(range(seq_len - subseq_len, seq_len)))
    return windows
