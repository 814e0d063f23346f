"""Where the port's entry points put their tensors.

The port is written for an NVIDIA card, so an entry point that is given no
device takes the card and fails where there is none. The CPU is never a
silent fallback: a caller who wants it (the CPU tests do) says
``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: torch.device | str | None, argument: str = "device",
                   ask: str | None = None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, raising RuntimeError naming
    ``argument`` when no CUDA card is available (``ask`` says how to ask for
    the CPU, by default ``pass <argument>="cpu"``); anything else ("cpu",
    "meta", "cuda:1", a torch.device) is honoured as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        ask = ask or f'pass {argument}="cpu"'
        raise RuntimeError(
            f"{argument}=None means the CUDA card, and torch.cuda.is_available() "
            f"is False; {ask} to run on the CPU"
        )
    return torch.device("cuda")
