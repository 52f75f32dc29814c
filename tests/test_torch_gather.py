"""K5's plain versions (``lane_gather_plain``, ``take_plain``, through the
dispatch K5 takes on the CPU) against the TPU gather kernels they port.

Each Pallas kernel body is re-declared as written in its script and run
through ``pl.pallas_call(..., interpret=True)`` at a reduced shape:
  #2 scripts/exp_pallas_dma.py:184 (dyngather_case),
  #3 scripts/exp_pallas_gather.py:47 (k1), #4 :62 (k2), #5 :77 (k3),
  #6 scripts/exp_dyngather.py:38 (make, both axes, repeat 2),
  #7 scripts/exp_probe_primitives.py:63 (f3) and #8 :93 (f4's grid),
  #9 scripts/exp_probe2.py:68 and :105.
Inputs come from seeded numpy; outputs are int32: every comparison is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from umgap_tpu_torch.ops import gather

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _interpret(kernel, out_shape, *args):
    return np.asarray(pl.pallas_call(
        kernel, in_specs=[VMEM] * len(args), out_specs=VMEM,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        interpret=True)(*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pallas2_dyngather_case_row_index_broadcast():
    def kernel(tile_ref, locb_ref, out_ref):
        idx = locb_ref[:]  # (TB, 128) int32, row index broadcast per lane
        out_ref[:] = jnp.take_along_axis(tile_ref[:], idx, axis=0)

    rng = np.random.default_rng(3)
    TB = 64
    tile = rng.integers(0, 1 << 30, size=(TB, 128), dtype=np.int32)
    rows = rng.integers(0, TB, size=(TB, 1), dtype=np.int32)
    locb = np.broadcast_to(rows, (TB, 128)).copy()
    want = _interpret(kernel, (TB, 128), tile, locb)
    # the port's form: the row index expanded over the lanes, not stored
    idx = _t(rows).expand(TB, 128)
    assert idx.stride() == (1, 0)
    got = gather.lane_gather(_t(tile), idx)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.lane_gather_plain(_t(tile), _t(locb)).numpy(), want)
    np.testing.assert_array_equal(
        gather.gather_rows(_t(tile), _t(rows[:, 0])).numpy(), want)


def test_pallas3_k1_take_1d():
    def k1(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)

    rng = np.random.default_rng(0)
    S, Q = 512, 256
    table = rng.integers(0, 100, size=(S,)).astype(np.int32)
    idx = rng.integers(0, S, size=(Q,)).astype(np.int32)
    want = _interpret(k1, (Q,), table, idx)
    np.testing.assert_array_equal(gather.take(_t(table), _t(idx)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        gather.take_plain(_t(table), _t(idx)).numpy(), want)
    # any index shape
    np.testing.assert_array_equal(
        gather.take(_t(table), _t(idx.reshape(16, 16))).numpy(),
        want.reshape(16, 16))


@pytest.mark.parametrize("shifted", [False, True])
def test_pallas4_5_k2_k3_sublane_gather(shifted):
    def k2(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)

    def k3(tab_ref, idx_ref, out_ref):
        i = idx_ref[:]
        rows = i >> 7
        out = jnp.take_along_axis(tab_ref[:], rows, axis=0)
        out_ref[:] = out

    rng = np.random.default_rng(0)
    S, Q = 1024, 1024
    table2d = rng.integers(0, 100, size=(S, 128)).astype(np.int32)
    hi = S * 128 if shifted else S
    idx2d = rng.integers(0, hi, size=(Q // 128, 128)).astype(np.int32)
    want = _interpret(k3 if shifted else k2, idx2d.shape, table2d, idx2d)
    # k3's shift is the caller's
    idx = _t(idx2d >> 7) if shifted else _t(idx2d)
    np.testing.assert_array_equal(
        gather.lane_gather(_t(table2d), idx).numpy(), want)
    np.testing.assert_array_equal(
        gather.lane_gather_plain(_t(table2d), idx).numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_pallas6_dyngather_repeat_and_sum(axis):
    S, repeat = 64, 2

    def kernel(x_ref, idx_ref, out_ref):
        x = x_ref[:]
        idx = idx_ref[:]
        acc = jnp.zeros_like(x)
        for _ in range(repeat):
            g = jnp.take_along_axis(x, idx, axis=axis)
            acc = acc + g
            idx = (idx + 1) % x.shape[axis]
        out_ref[:] = acc

    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 30, (S, 128)).astype(np.int32)
    hi = S if axis == 0 else 128
    idx = rng.integers(0, hi, (S, 128)).astype(np.int32)
    want = _interpret(kernel, (S, 128), x, idx)
    # the port: one K5 launch per repeat, summed (int32 wraps as on the TPU)
    xt, it = _t(x), _t(idx)
    acc = torch.zeros_like(xt)
    for _ in range(repeat):
        acc = acc + gather.lane_gather(xt, it, axis=axis - 2)
        it = (it + 1) % hi
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("S", [64, 512])
def test_pallas7_9_in_vmem_dynamic_gather(S):
    def k(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)

    rng = np.random.default_rng(S)
    tab = rng.integers(0, 2**31 - 1, size=(S, 128)).astype(np.int32)
    idx = rng.integers(0, S, size=(S, 128)).astype(np.int32)
    want = _interpret(k, (S, 128), tab, idx)
    np.testing.assert_array_equal(
        want, tab[idx, np.arange(128)[None, :]])
    np.testing.assert_array_equal(
        gather.lane_gather(_t(tab), _t(idx)).numpy(), want)


def test_pallas8_f4_grid_of_tiles_is_the_group_dimension():
    T, S = 4, 64

    def kt(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)

    rng = np.random.default_rng(1)
    tabT = rng.integers(0, 2**31 - 1, size=(T * S, 128)).astype(np.int32)
    idxT = rng.integers(0, S, size=(T * S, 128)).astype(np.int32)
    want = np.asarray(pl.pallas_call(
        kt, grid=(T,),
        in_specs=[pl.BlockSpec((S, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec((S, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((T * S, 128), jnp.int32),
        interpret=True)(tabT, idxT))
    got = gather.lane_gather(_t(tabT).view(T, S, 128),
                             _t(idxT).view(T, S, 128))
    np.testing.assert_array_equal(got.reshape(T * S, 128).numpy(), want)


@pytest.mark.parametrize("B,K,D", [(5, 4, 3), (16, 64, 26)])
def test_strided_index_matches_take_along_axis(B, K, D):
    """hit_geometry's form: a transposed table view and an index expanded
    over the lanes, against jnp.take_along_axis on materialised arrays."""
    rng = np.random.default_rng(B)
    lin = rng.integers(-1, 1000, size=(B, K, D)).astype(np.int32)
    dep = rng.integers(0, D, size=(B, K)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(
        jnp.swapaxes(jnp.asarray(lin), 1, 2),
        jnp.broadcast_to(jnp.asarray(dep)[:, :, None], (B, K, K)), axis=1))
    tab = _t(lin).transpose(1, 2)
    idx = _t(dep)[:, :, None].expand(B, K, K)
    assert not tab.is_contiguous() and idx.stride(2) == 0
    np.testing.assert_array_equal(gather.lane_gather(tab, idx).numpy(), want)
    # along the lanes: out[b, i, j] = lin[b, i, idx[b, i, j]]
    lidx = rng.integers(0, D, size=(B, K, K)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(lin),
                                          jnp.asarray(lidx), axis=-1))
    np.testing.assert_array_equal(
        gather.lane_gather(_t(lin), _t(lidx), axis=-1).numpy(), want)


@pytest.mark.parametrize("B,K,D", [(5, 4, 3), (16, 64, 26), (4, 408, 26)])
def test_ancestry_epilogue_matches_take_along_axis(B, K, D):
    """The ancestry epilogue (plain on the CPU) against jnp.take_along_axis
    on the transposed lineage, the compare and the two masks, with lin a
    view of [depth | lin] rows as hit_geometry passes it."""
    rng = np.random.default_rng(K)
    rows = rng.integers(-1, 50, size=(B, K, 1 + D)).astype(np.int32)
    dep = rng.integers(0, D, size=(B, K)).astype(np.int32)
    utaxa = rng.integers(-1, 50, size=(B, K)).astype(np.int32)
    valid = rng.random((B, K)) < 0.7
    lin = rows[..., 1:]
    a = np.asarray(jnp.take_along_axis(
        jnp.swapaxes(jnp.asarray(lin), 1, 2),
        jnp.broadcast_to(jnp.asarray(dep)[:, :, None], (B, K, K)), axis=1))
    want = (a == utaxa[:, :, None]) & valid[:, :, None] & valid[:, None, :]
    got = gather.ancestry(_t(rows)[..., 1:], _t(dep), _t(utaxa), _t(valid))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_active_selects_plain_versions():
    """gather.active() hands each stage K5's four wrappers, or their plain
    versions inside kernels.plain_versions()."""
    from umgap_tpu_torch import kernels

    assert gather.active() == (gather.take, gather.gather_rows,
                               gather.lane_gather, gather.ancestry)
    with kernels.plain_versions():
        assert gather.active() == (gather.take_plain, gather.take_plain,
                                   gather.lane_gather_plain,
                                   gather.ancestry_plain)


def test_take_and_row_gather_any_index_layout():
    """take and gather_rows read any index layout (a transposed view is
    made contiguous first), on the CPU through their plain versions."""
    rng = np.random.default_rng(5)
    tab1 = rng.integers(0, 1000, size=97).astype(np.int32)
    tab2 = rng.integers(0, 1000, size=(97, 6)).astype(np.int32)
    idx = rng.integers(0, 97, size=(7, 9)).astype(np.int32)
    view = _t(idx).t()
    np.testing.assert_array_equal(gather.take(_t(tab1), view).numpy(),
                                  tab1[idx.T])
    np.testing.assert_array_equal(gather.gather_rows(_t(tab2), view).numpy(),
                                  tab2[idx.T])
