"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default: the port runs on the card
unless the caller asks for the CPU. A CUDA device on a machine without one
raises here, with the reason, instead of failing later inside a tensor
constructor; there is no fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raise if it is CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (the default of the port's entry "
            "points), but torch sees no CUDA device; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


def l2_bytes(device) -> int:
    """The L2 cache of ``device``'s card in bytes (50 MiB on the H100): what
    keeps a sweep's gathered lines for their reuse. 0 for the CPU, where
    no cache is modelled, so the plain path there takes every ordering the
    card would take at some size, and the CPU tests hold the ordered path."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.get_device_properties(dev).L2_cache_size)
