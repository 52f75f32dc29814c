"""The port's world of devices (a counterpart of
``umgap_tpu.parallel.mesh``): one device."""

from __future__ import annotations

import torch


def make_mesh(n_devices=None, device=None) -> tuple[torch.device, ...]:
    """The devices of an ``n_devices`` mesh: ``None``, ``"auto"`` and 1
    give the session's device (:func:`~umgap_tpu_torch.device.
    resolve_device` of ``device``). A mesh of more devices is not ported
    yet and is refused."""
    from ..device import resolve_device

    n = 1 if n_devices in (None, "auto") else int(n_devices)
    if n > 1:
        raise NotImplementedError(
            f"--mesh {n}: a mesh of more than one device is not supported "
            "by umgap_tpu_torch yet (ROADMAP: multi-rank --mesh on "
            "torch.distributed); use --mesh 1 or --mesh auto")
    if n < 1:
        raise ValueError(f"--mesh {n}: need at least one device")
    return (resolve_device(device),)
