"""Resize / pad geometry shared by the engine and the output writers.

Exact replicas of the reference formulas, because they decide the output
geometry when the writers crop the /32 padding away:

* ``compute_resize_params``: scale so the smaller side equals ``min_dim``
  unless the larger side would then exceed ``max_dim``; new dims use
  Python's ``round`` (banker's rounding), as the reference does;
* ``pad_to_multiple``: the pad-to-32 of the network input.
"""

from __future__ import annotations

import math
from typing import Tuple


def compute_resize_params(image_dims: Tuple[int, int], min_resize_dim: int,
                          max_resize_dim: int) -> Tuple[int, int, float]:
    """:param image_dims: (width, height)
    :return: (new_width, new_height, scale_factor)"""
    lower_size = float(min(image_dims))
    higher_size = float(max(image_dims))

    scale_factor = min_resize_dim / lower_size
    if (higher_size * scale_factor) > max_resize_dim:
        scale_factor = max_resize_dim / higher_size

    width, height = image_dims
    new_height, new_width = round(scale_factor * height), round(scale_factor * width)
    return new_width, new_height, scale_factor


def round_to_nearest_multiple(value: int, multiple: int = 32) -> int:
    return int(math.ceil(value / multiple)) * multiple


def pad_to_multiple(height: int, width: int, multiple: int = 32) -> Tuple[int, int]:
    """:return: (padded_height, padded_width)."""
    return (round_to_nearest_multiple(height, multiple),
            round_to_nearest_multiple(width, multiple))
