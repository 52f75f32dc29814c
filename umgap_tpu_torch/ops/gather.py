"""Gathers from an int32 tile: kernel K5 (``csrc/lane_gather.cu``), its
ancestry epilogue, and their plain PyTorch versions.

K5 is the port of the eight in-VMEM gather Pallas kernels of the TPU
experiments (``scripts/exp_pallas_dma.py:171``, ``exp_pallas_gather.py:47,
:62, :77``, ``exp_dyngather.py:37``, ``exp_probe_primitives.py:66, :96``,
``exp_probe2.py:75, :87, :112``): ``take_along_axis`` along the rows
(each lane picks a row) or along the lanes of a tile, and a 1-D ``take``.
No path of the port launches it: the tree aggregators read their rows
in K6, the Euler/RMQ aggregators their tables in K9, and the
plain versions take this module's plain functions. ``hit_geometry``
uses its row gather and its epilogue :func:`ancestry`, which writes the
bool incidence with the compare and masks fused in; ``snap_batch`` and
``rmq_lca_batch`` / ``rmq_mix_batch`` called alone on the card take its
1-D take and its modes. Its bound is bytes: the
part of the tile it reads, once, plus the index tensor as stored and the
output.

Indices must lie in range: callers clamp them, as the JAX code does. The
index may have any strides; an ``expand``-ed index (stride 0) is read
in place and costs no memory. CPU tensors take the plain version; CUDA
tensors launch K5. The wrappers derive the launch arguments from shapes
and strides without building views, so a call costs little host time.
"""

from __future__ import annotations

import torch

from .. import kernels

# Whole tiles of at most this many bytes of shared memory are staged:
# chip_smoke.py's sweep over 1,024 tiles of 8-96 KB found staging ahead
# of the direct read at every size (PERF.md).
STAGE_BYTES = 96 * 1024
_I32 = torch.int32


def _one_cuda_device(name: str, a: torch.Tensor, *rest: torch.Tensor):
    """Raise unless all the tensors lie on one CUDA device."""
    dev = a.get_device()
    for t in rest:
        if t.get_device() != dev:
            dev = -1
    if dev < 0:
        raise ValueError(f"{name}: tensors must share one CUDA device")


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
    if tab.is_cpu:
        return lane_gather_plain(tab, idx, axis)
    return lane_gather_staging(tab, idx, axis, STAGE_BYTES)


def lane_gather_staging(tab: torch.Tensor, idx: torch.Tensor, axis: int,
                        stage_bytes: int) -> torch.Tensor:
    """:func:`lane_gather` on CUDA tensors with the staging limit given:
    whole tiles of at most ``stage_bytes`` of shared memory may be
    staged, 0 never stages (chip_smoke.py sweeps it)."""
    if axis != -2 and axis != -1:
        raise ValueError(f"lane_gather: axis {axis} (-2 or -1)")
    if tab.dtype != _I32 or idx.dtype != _I32:
        raise ValueError("lane_gather: tab and idx must be int32")
    shape, ishape = tab.shape, idx.shape
    st, ist = tab.stride(), idx.stride()
    if len(shape) == 3 and len(ishape) == 3:
        (G, S, W), (t0, t1, t2) = shape, st
        (Gi, I, J), (i0, i1, i2) = ishape, ist
    elif len(shape) == 2 and len(ishape) == 2:
        (S, W), (t1, t2) = shape, st
        (I, J), (i1, i2) = ishape, ist
        G = Gi = 1
        t0 = i0 = 0
    else:
        raise ValueError("lane_gather: tab and idx must both be 2-D or 3-D")
    if Gi != G or (J != W if axis == -2 else I != S):
        raise ValueError(f"lane_gather: tab {tuple(shape)} and idx "
                         f"{tuple(ishape)} do not match on axis {axis}")
    _one_cuda_device("lane_gather", tab, idx)
    out = idx.new_empty(ishape)
    kernels.K5.launch(axis, tab.data_ptr(), G, S, W, t0, t1, t2,
                      idx.data_ptr(), I, J, i0, i1, i2, out.data_ptr(),
                      stage_bytes, kernels.stream_of(tab))
    return out


def take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`take`: indexing."""
    return tab[idx.to(torch.int64)]


def take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """1-D ``take``: ``out[...] = tab[idx[...]]``, tab (S,) int32, idx int32
    of any shape, every entry in range (K5 in its rows mode with
    G = W = 1)."""
    if tab.is_cpu:
        return take_plain(tab, idx)
    return _rows_of(tab, idx, 1)


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``tab[idx]``: tab (S, W) int32, idx int32 of any shape,
    out idx.shape + (W,); K5 in its rows mode with the index expanded
    over the lanes."""
    if tab.is_cpu:
        return take_plain(tab, idx)
    return _rows_of(tab, idx, 2)


def _rows_of(tab: torch.Tensor, idx: torch.Tensor, nd: int) -> torch.Tensor:
    """K5's rows mode on one (S, W) table (a 1-D table is W = 1) with the
    flattened index read once per row (lane stride 0)."""
    if tab.dim() != nd:
        raise ValueError(f"{'take' if nd == 1 else 'gather_rows'}: tab must "
                         f"be {nd}-D")
    if tab.dtype != _I32 or idx.dtype != _I32:
        raise ValueError("take, gather_rows: tab and idx must be int32")
    _one_cuda_device("take, gather_rows", tab, idx)
    idx = idx.contiguous()
    if nd == 1:
        S, W, t1, t2 = tab.shape[0], 1, tab.stride(0), 0
        out = idx.new_empty(idx.shape)
    else:
        (S, W), (t1, t2) = tab.shape, tab.stride()
        out = idx.new_empty((*idx.shape, W))
    kernels.K5.launch(-2, tab.data_ptr(), 1, S, W, 0, t1, t2,
                      idx.data_ptr(), idx.numel(), W, 0, 1, 0,
                      out.data_ptr(), STAGE_BYTES, kernels.stream_of(tab))
    return out


def ancestry_plain(lin: torch.Tensor, dep: torch.Tensor, utaxa: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ancestry`: the gather
    ``lane_gather_plain(lin^T, dep expanded)``, then the compare and the
    two masks."""
    B, K, _D = lin.shape
    a = lane_gather_plain(lin.transpose(1, 2),
                          dep[:, :, None].expand(B, K, K))
    return (a == utaxa[:, :, None]) & valid[:, :, None] & valid[:, None, :]


def ancestry(lin: torch.Tensor, dep: torch.Tensor, utaxa: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Ancestor incidence, K5's epilogue: ``is_anc[b, i, j] =
    (lin[b, j, dep[b, i]] == utaxa[b, i]) & valid[b, i] & valid[b, j]``
    as a (B, K, K) bool tensor, with no int32 (B, K, K) intermediate.
    lin (B, K, D) int32, any strides; dep, utaxa (B, K) int32 and valid
    (B, K) bool (read contiguous); dep in [0, D) where valid."""
    if lin.is_cpu:
        return ancestry_plain(lin, dep, utaxa, valid)
    if lin.dim() != 3 or lin.dtype != _I32:
        raise ValueError("ancestry: lin must be (B, K, D) int32")
    B, K, _D = lin.shape
    for name, t, dt in (("dep", dep, _I32), ("utaxa", utaxa, _I32),
                        ("valid", valid, torch.bool)):
        if t.dtype != dt or t.shape != (B, K):
            raise ValueError(f"ancestry: {name} must be ({B}, {K}) {dt}")
    _one_cuda_device("ancestry", lin, dep, utaxa, valid)
    dep, utaxa, valid = dep.contiguous(), utaxa.contiguous(), \
        valid.contiguous()
    out = valid.new_empty((B, K, K))
    s0, s1, s2 = lin.stride()
    kernels.K5A.launch(lin.data_ptr(), B, K, s0, s1, s2, dep.data_ptr(),
                       utaxa.data_ptr(), valid.data_ptr(), out.data_ptr(),
                       kernels.stream_of(lin))
    return out


def active():
    """``(take, gather_rows, lane_gather, ancestry)`` for the calling
    stage: K5's wrappers, or inside :func:`kernels.plain_versions` their
    plain versions (indexing is the plain row gather)."""
    if kernels.plain_selected():
        return take_plain, take_plain, lane_gather_plain, ancestry_plain
    return take, gather_rows, lane_gather, ancestry
