"""Explicit device selection: the port never picks a device on its own."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """Turn a device name into a ``torch.device``.

    Raises when a CUDA device is asked for and none is present; there is
    no silent move to the CPU.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           f"available (torch {torch.__version__})")
    return dev
