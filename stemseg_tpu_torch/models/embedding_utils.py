"""Embedding dimension modes and the fixed spatio-temporal coordinate grid.

Channel order follows the reference: for mode "xyt" the embedding channels
are offset by (t, y, x) in that order; free dims get no offset.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MODE_EMB_DIMS = {
    "xy": 2, "ff": 2,
    "xyt": 3, "xyf": 3,
    "xytf": 4, "xyff": 4,
    "xytff": 5, "xyfff": 5,
}

_MODE_FREE_DIMS = {
    "xyf": 1, "xytf": 1,
    "xyff": 2, "xytff": 2,
    "xyfff": 3,
}

_MODE_GRID = {
    "x": ("x",), "xy": ("y", "x"), "xyt": ("t", "y", "x"),
    "xyf": ("y", "x", "0"), "xytf": ("t", "y", "x", "0"),
    "xyff": ("y", "x", "0", "0"), "xytff": ("t", "y", "x", "0", "0"),
    "xyfff": ("y", "x", "0", "0", "0"), "xyffff": ("y", "x", "0", "0", "0", "0"),
}


def get_nb_embedding_dims(mode: str) -> int:
    try:
        return _MODE_EMB_DIMS[mode]
    except KeyError:
        raise ValueError(f"Invalid embedding dim mode: {mode!r}")


def get_nb_free_dims(mode: str) -> int:
    return _MODE_FREE_DIMS.get(mode, 0)


def create_spatiotemporal_grid(height: int, width: int, time: int, t_scale,
                               device=None) -> Tuple[torch.Tensor, ...]:
    """Aspect-normalised coordinate grids, each ``[T, H, W]`` float32:
    x spans ±max(1, w/h), y spans ±max(1, h/w), t spans ±t_scale."""
    x_abs = max(1.0, width / float(height))
    y_abs = max(1.0, height / float(width))
    x = torch.linspace(-x_abs, x_abs, width, dtype=torch.float32, device=device)
    y = torch.linspace(-y_abs, y_abs, height, dtype=torch.float32, device=device)
    t = torch.linspace(-1.0, 1.0, time, dtype=torch.float32, device=device) * t_scale
    tg, yg, xg = torch.meshgrid(t, y, x, indexing="ij")
    return tg, yg, xg


def add_spatiotemporal_offset(embeddings: torch.Tensor, time_scale,
                              mode: str) -> torch.Tensor:
    """Add the coordinate grid to the embedding channels.

    :param embeddings: ``[N, E, T, H, W]``
    :param time_scale: scalar tensor (the decoder's ``time_scale`` buffer)
    """
    if mode == "ff":
        return embeddings
    if mode not in _MODE_GRID:
        raise ValueError(f"Invalid embedding dim mode: {mode!r}")
    _, _, t_len, h, w = embeddings.shape
    tg, yg, xg = create_spatiotemporal_grid(h, w, t_len, time_scale,
                                            embeddings.device)
    by_name = {"t": tg, "y": yg, "x": xg, "0": torch.zeros_like(xg)}
    grid = torch.stack([by_name[c] for c in _MODE_GRID[mode]], dim=0)[None]
    return embeddings + grid.to(embeddings.dtype)
