"""The port's default device.

The default is ``cuda``. A caller switches it with ``set_device("cpu")``
(the tests do); no environment variable switches it. Asking for ``cuda``
on a machine without a usable card raises: the port never carries on on
the CPU by itself.
"""
from __future__ import annotations

import torch

_DEVICE = "cuda"


def set_device(name: str) -> str:
    """Select the default device, ``"cuda"`` or ``"cpu"``; returns the
    previous one."""
    global _DEVICE
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}: expected 'cuda' or 'cpu'")
    prev, _DEVICE = _DEVICE, name
    return prev


def get_device() -> torch.device:
    """The default device; raises if it is ``cuda`` and no card is usable."""
    return resolve(None)


def resolve(device) -> torch.device:
    """``device`` as a torch.device (None: the default), checked usable."""
    dev = torch.device(_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lighthouse_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is false; call set_device('cpu') "
            "to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
