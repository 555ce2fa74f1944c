"""Device selection for the port's entry points.

``None`` means the CUDA device.  Asking for CUDA where there is none
raises: a run never drops to the CPU on its own, because a CPU result
reported as a GPU one is wrong.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` / ``"cuda"`` / ``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``; raises on CUDA without a card and on other types."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
