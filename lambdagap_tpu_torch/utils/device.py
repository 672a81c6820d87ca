"""``device_type`` -> ``torch.device``.

The port's entry points run on the card unless the caller asks for the
CPU. Asking for the card where none is visible is an error: the port never
carries on on the CPU behind the caller's back.
"""
from __future__ import annotations

import torch


def resolve_device(device_type: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device (raises when none is
    visible); ``"cpu"`` -> the CPU, where every kernel wrapper takes its
    plain PyTorch version."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type=cuda (the default) but no CUDA device is "
                "visible; pass device_type=cpu to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device_type {device_type!r} "
                     "(expected 'cuda' or 'cpu')")
