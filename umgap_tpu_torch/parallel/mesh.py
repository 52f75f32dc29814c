"""The port's meshes: the devices one process serves over (a tuple of
devices, :func:`make_mesh`, the counterpart of ``umgap_tpu.parallel.
mesh``, whose mesh is one process over its local devices), and a mesh
that spans processes (:class:`ProcessMesh`, the global mesh of
``umgap_tpu.parallel.multihost``)."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
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


@dataclass(frozen=True)
class ProcessMesh:
    """A mesh that spans processes (``umgap_tpu``'s global mesh of
    umgap_tpu/parallel/multihost.py:53-74): ``world_size`` processes of
    ``torch.distributed``, each over the same number of local devices.
    ``local`` is this process's (rank ``rank``) tuple of devices, which
    may repeat a device as :func:`make_mesh`'s ``devices`` may. Device
    ``d`` of rank ``r`` is global device ``r * len(local) + d``:
    host-major, as ``umgap_tpu`` orders its devices by (process, id).
    ``shape`` is ``(world_size, len(local))`` for the pod grid and
    ``(world_size * len(local),)`` for the flat mesh; both order the
    devices alike."""

    rank: int
    world_size: int
    local: tuple
    shape: tuple = ()

    def __post_init__(self):
        if not self.local:
            raise ValueError("a process mesh needs at least one local "
                             "device")
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world_size}")
        n = self.world_size * len(self.local)
        if not self.shape:
            object.__setattr__(self, "shape", (n,))
        if int(np.prod(self.shape)) != n:
            raise ValueError(f"mesh shape {self.shape} does not hold {n} "
                             "devices")

    @property
    def n_local(self) -> int:
        return len(self.local)

    @property
    def n_devices(self) -> int:
        """The global device count."""
        return self.world_size * self.n_local

    def global_index(self, d: int) -> int:
        """The global index of local device ``d``."""
        return self.rank * self.n_local + d

    def grid(self) -> np.ndarray:
        """The global device indices laid out in ``shape``."""
        return np.arange(self.n_devices).reshape(self.shape)
