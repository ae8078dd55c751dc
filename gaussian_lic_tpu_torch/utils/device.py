"""The port's device rule: an entry point runs on the card unless its caller
asks for the CPU, and it never falls back from one to the other."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device], who: str) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and none is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device {str(device)!r} but no CUDA device is available; "
                           "pass device=\"cpu\" to run the plain PyTorch versions on the CPU")
    return dev
