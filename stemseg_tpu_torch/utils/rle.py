"""COCO run-length encoding of binary masks (the wire format of
``pycocotools.mask``), in numpy.

* A mask is read in column-major (Fortran) order as alternating runs,
  background first (a mask starting with foreground opens with a run of 0).
* The compressed string packs each count as a varint of 5-bit groups,
  0x20 marking a continuation, offset by 48 into printable ASCII; from the
  third count on, a count is stored as its difference to ``counts[i - 2]``.

``encode`` / ``decode`` / ``area`` / ``toBbox`` take one RLE dict (or
``encode`` an ``[H, W, N]`` stack); ``counts`` is ``bytes`` (``str``
accepted).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, object]


def counts_to_string(counts: Sequence[int]) -> bytes:
    s = bytearray()
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # arithmetic shift
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def string_to_counts(s: Union[bytes, str]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i, n = 0, len(s)
    while i < n:
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _mask_to_counts(mask: np.ndarray) -> List[int]:
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]])).tolist()
    return [0] + runs if flat[0] == 1 else runs


def _counts_of(rle: RLE) -> List[int]:
    counts = rle["counts"]
    return string_to_counts(counts) if isinstance(counts, (bytes, str)) else list(counts)


def encode(mask: np.ndarray) -> Union[RLE, List[RLE]]:
    """``[H, W]`` (or ``[H, W, N]``) {0, 1} mask -> compressed RLE dict(s)."""
    if mask.ndim == 3:
        return [encode(mask[:, :, i]) for i in range(mask.shape[2])]
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(_mask_to_counts(mask))}


def decode(rle: RLE) -> np.ndarray:
    """RLE dict -> ``[H, W]`` uint8 mask, C-contiguous."""
    h, w = (int(v) for v in rle["size"])
    counts = _counts_of(rle)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, np.asarray(counts, np.int64))
    if flat.size != h * w:
        raise ValueError(f"RLE covers {flat.size} pixels, expected {h * w}")
    return np.ascontiguousarray(flat.reshape((w, h)).T)


def area(rle: RLE) -> int:
    return int(sum(_counts_of(rle)[1::2]))


def toBbox(rle: RLE) -> np.ndarray:
    """``[x, y, w, h]`` float64 box of the foreground, pycocotools' rleToBbox."""
    h = int(rle["size"][0])
    counts = _counts_of(rle)
    if len(counts) <= 1 or sum(counts[1::2]) == 0:
        return np.zeros(4, np.float64)
    ends = np.cumsum(counts)
    starts = ends - np.asarray(counts)
    fg_starts, fg_ends = starts[1::2], ends[1::2] - 1  # inclusive
    xs_start, ys_start = fg_starts // h, fg_starts % h
    xs_end, ys_end = fg_ends // h, fg_ends % h
    spans_cols = xs_end > xs_start  # such a run covers whole columns' height
    y0 = int(np.min(np.where(spans_cols, 0, ys_start)))
    y1 = int(np.max(np.where(spans_cols, h - 1, ys_end)))
    x0, x1 = int(np.min(xs_start)), int(np.max(xs_end))
    return np.asarray([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float64)
