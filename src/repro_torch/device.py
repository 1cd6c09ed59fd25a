"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when it names a card that is not
    there, so an entry point never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
