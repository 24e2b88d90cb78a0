"""Where an entry point of the port runs."""
from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """device as a torch.device. "cuda" (every entry point's default)
    raises without a card: the caller passes device="cpu" to run the
    plain versions on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' to "
                           f"decode on the CPU")
    return dev
