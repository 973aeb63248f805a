"""The port's device rule: its entry points run on the card unless the
caller asks for the CPU."""
from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; asking for CUDA on a host without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, read once (the kernels'
    launch plans read it on every call)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
