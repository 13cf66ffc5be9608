"""Device selection: the port runs on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a plan, session or one-shot call runs on.

    ``None`` means ``cuda``.  When CUDA is unavailable that raises: the port
    never moves to the CPU on its own, so a missing card cannot pass for a
    (much slower) CPU run.  Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
