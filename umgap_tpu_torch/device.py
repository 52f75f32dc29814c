"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. There is
deliberately no "cuda if available, else cpu" picker: a run that finds
no card fails and says how to ask for the CPU, so a CPU run is never
mistaken for a GPU one.
"""

from __future__ import annotations

import torch

CPU_HINT = ("pass device='cpu' (command line: --device cpu) to run the "
            "plain PyTorch path on the CPU")


class NoCudaDevice(RuntimeError):
    """No CUDA device is visible and the CPU was not asked for."""


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given (``"cpu"``, ``"cuda"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice(f"no CUDA device is visible; {CPU_HINT}")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                f"device {device!r} asked for but no CUDA device is "
                f"visible; {CPU_HINT}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def state_device(dtax=None, dtable=None, device=None) -> torch.device:
    """The device of given device state (``dtable``, else ``dtax``), else
    :func:`resolve_device` of ``device``: what an entry point that takes
    prebuilt state runs on."""
    if dtable is not None:
        return dtable.device
    if dtax is not None:
        return dtax.device
    return resolve_device(device)
