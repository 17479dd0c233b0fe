"""Device selection and the float32 numerics of the port, set in one place.

Entry points take ``device="cuda"`` by default and raise when no CUDA device
exists: a caller that wants the CPU says so with ``device="cpu"``.

TF32 is off for both convolutions (cuDNN) and matrix products, so the
forward runs in full float32 like the reference forward.
"""

from __future__ import annotations

import torch

ALLOW_TF32 = False


def set_numerics() -> None:
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point; raises if CUDA is asked for (the
    default) and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    set_numerics()
    return dev
