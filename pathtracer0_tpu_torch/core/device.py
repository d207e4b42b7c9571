"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU. When no
card is present and the caller did not ask for the CPU they raise: the
port never moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda"; "cuda" means the current card. A CUDA device
    without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(dev: torch.device):
    """Wait for the work queued on `dev` where it is a card; the CPU runs
    each op to its end before it returns."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
