"""The port's mesh: the devices one process serves over (a counterpart of
``umgap_tpu.parallel.mesh``, whose mesh is one process over its local
devices)."""

from __future__ import annotations

import contextlib

import torch


def make_mesh(n_devices=None, device=None,
              devices=None) -> tuple[torch.device, ...]:
    """The devices of an ``n_devices`` mesh, as a tuple.

    On CUDA these are ``cuda:0`` .. ``cuda:N-1``; ``None`` and ``"auto"``
    take every visible card, and more cards than are visible are refused
    with ``umgap_tpu``'s message (nothing is emulated on a card). A mesh
    of one device is the session's device (:func:`~umgap_tpu_torch.
    device.resolve_device` of ``device``). With ``device="cpu"`` the mesh
    is ``n_devices`` entries of the CPU (``auto``: one), the counterpart
    of JAX's virtual CPU devices. ``devices`` gives the tuple itself,
    which may repeat a device (a four-device mesh on one card); the
    command line never builds one."""
    from ..device import resolve_device

    if devices is not None:
        return tuple(resolve_device(d) for d in devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices in (None, "auto") else int(n_devices)
        if n > have:
            raise ValueError(f"need {n} devices, have {have}")
    else:
        n = 1 if n_devices in (None, "auto") else int(n_devices)
    if n < 1:
        raise ValueError(f"--mesh {n}: need at least one device")
    if n == 1:
        return (dev,)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(n))
    return (dev,) * n


def on_device(dev: torch.device):
    """A context in which work is issued to ``dev``: its CUDA device made
    current (a kernel launches on the current device's streams), nothing
    on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
