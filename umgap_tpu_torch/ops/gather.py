"""Gathers from an int32 tile: kernel K5 (``csrc/lane_gather.cu``) and
its plain PyTorch versions.

K5 is the port of the eight in-VMEM gather Pallas kernels of the TPU
experiments (``scripts/exp_pallas_dma.py:171``, ``exp_pallas_gather.py:47,
:62, :77``, ``exp_dyngather.py:37``, ``exp_probe_primitives.py:66, :96``,
``exp_probe2.py:75, :87, :112``): ``take_along_axis`` along the rows
(each lane picks a row) or along the lanes of a tile, and a 1-D ``take``.
On the port's path it carries every table read of the aggregation
stage. Its bound is bytes: the part of the tile it reads, once, plus the
index tensor as stored and the output.

Indices must lie in range: callers clamp them, as the JAX code does. The
index may have any strides; an ``expand``-ed index (stride 0) is read
in place and costs no memory. CPU tensors take the plain version; CUDA
tensors launch K5.
"""

from __future__ import annotations

import torch

from .. import kernels


def _as3(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(0) if t.dim() == 2 else t


def lane_gather_plain(tab: torch.Tensor, idx: torch.Tensor,
                      axis: int = -2) -> torch.Tensor:
    """Plain version of :func:`lane_gather`: ``torch.gather``."""
    return torch.gather(tab, axis, idx.to(torch.int64))


def lane_gather(tab: torch.Tensor, idx: torch.Tensor,
                axis: int = -2) -> torch.Tensor:
    """``take_along_axis`` of an int32 tile, batched over a leading group
    dimension G (absent for 2-D operands).

    ``axis=-2`` (rows): ``out[g, i, l] = tab[g, idx[g, i, l], l]``, tab
    (G, S, W), idx (G, I, W). ``axis=-1`` (lanes):
    ``out[g, i, j] = tab[g, i, idx[g, i, j]]``, tab (G, I, W), idx
    (G, I, J). idx is int32, any strides, every entry in range."""
    if tab.device.type == "cpu":
        return lane_gather_plain(tab, idx, axis)
    if axis not in (-2, -1):
        raise ValueError(f"lane_gather: axis {axis} (-2 or -1)")
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError("lane_gather: tab and idx must be int32")
    if tab.dim() != idx.dim() or tab.dim() not in (2, 3):
        raise ValueError("lane_gather: tab and idx must both be 2-D or 3-D")
    if idx.device != tab.device:
        raise ValueError(f"lane_gather: tensors on {idx.device} and "
                         f"{tab.device}")
    t3, i3 = _as3(tab), _as3(idx)
    G, S, W = t3.shape
    _, I, J = i3.shape
    if i3.shape[0] != G or (axis == -2 and J != W) or \
            (axis == -1 and I != S):
        raise ValueError(f"lane_gather: tab {tuple(tab.shape)} and idx "
                         f"{tuple(idx.shape)} do not match on axis {axis}")
    out = torch.empty((G, I, J), dtype=torch.int32, device=tab.device)
    kernels.K5.launch(axis, t3.data_ptr(), G, S, W, *t3.stride(),
                      i3.data_ptr(), I, J, *i3.stride(), out.data_ptr(),
                      kernels.stream_handle(tab.device))
    return out if tab.dim() == 3 else out[0]


def take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`take`: indexing."""
    return tab[idx.to(torch.int64)]


def take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """1-D ``take``: ``out[...] = tab[idx[...]]``, tab (S,) int32, idx int32
    of any shape, every entry in range (K5 in its rows mode with
    G = W = 1)."""
    if tab.device.type == "cpu":
        return take_plain(tab, idx)
    if tab.dim() != 1:
        raise ValueError("take: tab must be 1-D")
    flat = idx.reshape(-1)
    return lane_gather(tab.view(-1, 1), flat.view(-1, 1)).view(idx.shape)


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``tab[idx]``: tab (S, W) int32, idx int32 of any shape,
    out idx.shape + (W,); K5 in its rows mode with the index expanded
    over the lanes."""
    if tab.device.type == "cpu":
        return take_plain(tab, idx)
    flat = idx.reshape(-1, 1)
    rows = lane_gather(tab, flat.expand(flat.shape[0], tab.shape[1]))
    return rows.view(*idx.shape, tab.shape[1])


def active():
    """``(take, gather_rows, lane_gather)`` for the calling stage: K5's
    wrappers, or inside :func:`kernels.plain_versions` their plain
    versions (indexing is the plain row gather)."""
    if kernels.plain_selected():
        return take_plain, take_plain, lane_gather_plain
    return take, gather_rows, lane_gather
