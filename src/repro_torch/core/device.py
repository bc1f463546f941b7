"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Asking for CUDA on a machine without a card
    raises: an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    return dev


def card_program(device) -> bool:
    """Whether tensors on `device` run the card's program (bf16
    containers, the kernels' routes): a CUDA device, or the meta device,
    on which the dry run stands in for the card (`launch/dryrun.py`)."""
    return torch.device(device).type in ("cuda", "meta")
