"""The port's processes across hosts (``umgap_tpu_torch.parallel.
multihost``) against ``umgap_tpu``'s, on the CPU over gloo: real ranks,
each a subprocess running this file's ``__main__`` (the workers import
the port only; this process builds the data from
``__graft_entry__._toy_world`` and hands it over as ``.npz`` files).

At 2 ranks x 4 CPU devices, 2 x 1 and 4 x 1, max-sensitivity (k_max 32)
and tryptic-sensitivity (k_max 16, the four peptides of
``tests/test_multihost.py`` and fragments of the reads; the 9-mer index
also holds k-mers of the reads, so that taxa are found) give taxa
gathered over the ranks equal to
``umgap_tpu``'s single-process ``pipeline_step`` /
``tryptic_pipeline_step``, and a summed rank-frequency vector equal to
``umgap_tpu``'s sharded step's over its 8 virtual CPU devices; 15 groups
over 2 ranks leave a short last slice. Also ``per_host_groups``, the
mesh orders, ``ShardedTable.from_shards`` over a process mesh (only the
rank's own shards read, ``umgap_tpu``'s shards carried across), the
refusal of nccl on one card (monkeypatched) and of a run without a card.
Every output is integers: equality is exact."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PEPS = ["AAAAAAAAAK", "CDEFGHILMN", "QQQQSTVWYA", "MSTVWYACDE"]
PEP_IDS = [2, 10239, 12884, 185751]
B, E, L = 16, 2, 48
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_keys(dna, lengths, rng, ids):
    """Keys the reads hold, so that the steps find taxa (the toy world's
    random keys never occur in random reads): every third 9-mer of their
    six frames and every second tryptic fragment of 9-45 residues, each
    with a taxon of ``ids``."""
    from umgap_tpu.ops import encoding as jenc
    from umgap_tpu.ops import kmers as jkmers
    from umgap_tpu.ops import translate as jtrans

    code = jenc.get_table(1)
    aa, pl = jtrans.translate6_batch(dna.reshape(-1, L), lengths.reshape(-1),
                                     code)
    hi, lo, v = (np.asarray(x) for x in jkmers.pack_windows_batch(aa, pl, 9))
    keys = np.unique(jkmers.join_packed(hi[v], lo[v]))[::3]
    peps = sorted({f for row in dna.reshape(-1, L)
                   for p in jtrans.translate_sequence(
                       jenc.decode_dna(row), jtrans.FRAME_NAMES, code)
                   for f in jkmers.tryptic_digest(p) if 9 <= len(f) <= 45})
    peps = peps[::2]
    return (keys, rng.choice(ids, size=len(keys)).astype(np.int32), peps,
            rng.choice(ids, size=len(peps)).astype(np.int32))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """``__graft_entry__._toy_world`` (its taxonomy, keys and values) and
    16 read groups from seed 2 (as tests/test_multihost.py draws them),
    with keys and tryptic fragments of the reads added to its 9-mer
    index and to the four peptides; in an .npz for the workers, with
    umgap_tpu's answers on them."""
    import __graft_entry__ as ge
    from umgap_tpu.index.table import PeptideTable, build_kmer_table
    from umgap_tpu.ops import lookup
    from umgap_tpu.pipeline import PRESETS
    from umgap_tpu.pipeline.fused import pipeline_step
    from umgap_tpu.pipeline.tryptic import (
        TRYPTIC_PRESETS,
        tryptic_pipeline_step,
    )

    tax, dtax, packed, values = ge._toy_world()
    rng = np.random.default_rng(2)
    dna = rng.integers(0, 4, size=(B, E, L)).astype(np.uint8)
    lengths = np.full((B, E), L, dtype=np.int32)
    keys, kvals, frags, fvals = _read_keys(dna, lengths, rng, values)
    fresh = ~np.isin(keys, packed)
    packed = np.concatenate([packed, keys[fresh]])
    values = np.concatenate([values, kvals[fresh]])
    peps = PEPS + [f for f in frags if f not in PEPS]
    pvals = np.concatenate([np.array(PEP_IDS, np.int32),
                            fvals[[f not in PEPS for f in frags]]])
    path = tmp_path_factory.mktemp("multihost") / "world.npz"
    np.savez(path, packed=packed, values=values, dna=dna, lengths=lengths,
             peptides=np.array(peps), pvalues=pvals)
    config = PRESETS["max-sensitivity"]._replace(k_max=32)
    tconfig = TRYPTIC_PRESETS["tryptic-sensitivity"]._replace(k_max=16)
    dtable = lookup.DeviceTable.from_host(build_kmer_table(packed, values,
                                                           k=9))
    ptable = lookup.DeviceTable.from_host(PeptideTable.build(peps, pvals))
    return dict(
        path=path, tax=tax, dtax=dtax, packed=packed, values=values,
        peps=peps, pvals=pvals, dna=dna, lengths=lengths, config=config,
        tconfig=tconfig,
        taxa=np.asarray(pipeline_step(dna, lengths, dtax, dtable, config)),
        ttaxa=np.asarray(tryptic_pipeline_step(dna, lengths, dtax, ptable,
                                               tconfig)))


def _jax_sharded_freq(toy, tryptic: bool):
    """umgap_tpu's sharded step over its 8 virtual CPU devices: the
    psum'd rank-frequency vector of the 16 groups."""
    import jax.numpy as jnp
    from umgap_tpu.parallel import make_mesh
    from umgap_tpu.parallel import sharded as jsharded

    mesh = make_mesh(8)
    if tryptic:
        shards = jsharded.build_sharded_peptide_tables(
            toy["peps"], toy["pvals"], n_shards=8)
        maker, config = jsharded.make_sharded_tryptic_pipeline, toy[
            "tconfig"]
    else:
        shards = jsharded.build_sharded_tables(toy["packed"], toy["values"],
                                               k=9, n_shards=8)
        maker, config = jsharded.make_sharded_pipeline, toy["config"]
    step = maker(toy["dtax"], jsharded.ShardedTable.from_shards(shards, mesh),
                 config, mesh)
    taxa, freq = step(jnp.asarray(toy["dna"]), jnp.asarray(toy["lengths"]))
    return np.asarray(taxa), np.asarray(freq)


def _jax_rank_freq(toy, taxa):
    """umgap_tpu's ``_agg_tail`` frequency formula on ``taxa``: each
    taxon's snap_ranked rank (0 when unsnappable), counted."""
    from umgap_tpu.agg import device as jagg

    sr = toy["dtax"].snap_ranked
    ranks = np.asarray(jagg.snap_batch(sr, taxa, default=0))
    n = int(sr.shape[0])
    return np.bincount(np.clip(ranks, 0, n - 1), minlength=n).astype(
        np.float32)


def run_ranks(mode, world, n_local, data_path, tmp_path, groups=B):
    """Run ``world`` ranks of this file's worker (``mode`` "step" on CPU
    devices, "step-cuda" on cuda:0, "nccl") over the .npz at
    ``data_path``; returns rank 0's result."""
    port = _free_port()
    out = tmp_path / "result.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(port),
         str(r), str(world), str(n_local), str(groups), str(data_path),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {se.decode()[-3000:]}"
    return dict(np.load(out))


@pytest.mark.multiprocess
@pytest.mark.parametrize("world,n_local", [(2, 4), (2, 1), (4, 1)])
def test_ranks_match_jax(toy, tmp_path, world, n_local):
    """``world`` gloo ranks of ``n_local`` CPU devices each: taxa equal
    umgap_tpu's single-process steps, the summed frequency vectors its
    sharded steps' (8 virtual devices); the pod grid is (world,
    n_local)."""
    got = run_ranks("step", world, n_local, toy["path"], tmp_path)
    assert got["grid"].shape == (world, n_local)
    assert np.array_equal(got["grid"].ravel(), np.arange(world * n_local))
    jt, jf = _jax_sharded_freq(toy, False)
    jtt, jtf = _jax_sharded_freq(toy, True)
    assert np.array_equal(jt, toy["taxa"]) and np.array_equal(jtt,
                                                              toy["ttaxa"])
    assert np.array_equal(got["taxa"], toy["taxa"])
    assert np.array_equal(got["freq"], jf) and got["freq"].sum() == B
    assert np.array_equal(got["ttaxa"], toy["ttaxa"])
    assert np.array_equal(got["tfreq"], jtf) and got["tfreq"].sum() == B
    assert np.array_equal(_jax_rank_freq(toy, toy["taxa"]), jf)
    assert (toy["taxa"] != 1).sum() > 8 and (toy["ttaxa"] != 1).sum() > 8


@pytest.mark.multiprocess
def test_uneven_last_slice(toy, tmp_path):
    """15 groups over 2 ranks of 2 devices: rank 0 takes 8, rank 1 7 and
    a padding group; the gathered taxa and the frequencies count the 15
    real groups only."""
    got = run_ranks("step", 2, 2, toy["path"], tmp_path, groups=15)
    from umgap_tpu.ops import lookup
    from umgap_tpu.index.table import PeptideTable, build_kmer_table
    from umgap_tpu.pipeline.fused import pipeline_step
    from umgap_tpu.pipeline.tryptic import tryptic_pipeline_step

    dna, lens = toy["dna"][:15], toy["lengths"][:15]
    want = np.asarray(pipeline_step(
        dna, lens, toy["dtax"], lookup.DeviceTable.from_host(
            build_kmer_table(toy["packed"], toy["values"], k=9)),
        toy["config"]))
    twant = np.asarray(tryptic_pipeline_step(
        dna, lens, toy["dtax"], lookup.DeviceTable.from_host(
            PeptideTable.build(toy["peps"], toy["pvals"])), toy["tconfig"]))
    assert np.array_equal(want, toy["taxa"][:15])
    assert np.array_equal(got["taxa"], want)
    assert np.array_equal(got["ttaxa"], twant)
    assert np.array_equal(got["freq"], _jax_rank_freq(toy, want))
    assert np.array_equal(got["tfreq"], _jax_rank_freq(toy, twant))
    assert got["freq"].sum() == got["tfreq"].sum() == 15


@pytest.mark.multiprocess
def test_nccl_refused_on_one_card(toy, tmp_path):
    """Two ranks asking for nccl on one card (the card and the group
    monkeypatched: gloo carries the check) are refused with the reason,
    and leave no process group behind."""
    got = run_ranks("nccl", 2, 1, toy["path"], tmp_path)
    msg = str(got["error"])
    assert "needs one card a rank" in msg and "duplicate GPU" in msg
    assert "ranks 0 and 1" in msg
    assert not bool(got["initialized"])


def test_refuse_shared_cards():
    from umgap_tpu_torch.parallel.multihost import refuse_shared_cards

    refuse_shared_cards([("a", "GPU-0"), ("a", "GPU-1"), ("b", "GPU-0")])
    with pytest.raises(ValueError, match="ranks 1 and 2 both use card GPU-1"):
        refuse_shared_cards([("a", "GPU-0"), ("a", "GPU-1"),
                             ("a", "GPU-1")])


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5, 8])
def test_per_host_groups_match_jax(world):
    from umgap_tpu.parallel.multihost import per_host_groups as jphg
    from umgap_tpu_torch.parallel import per_host_groups

    for n in (0, 1, 7, 15, 16, 17, 100):
        groups = list(range(n))
        parts = [per_host_groups(groups, r, world) for r in range(world)]
        assert parts == [jphg(groups, r, world) for r in range(world)]
        assert sum(parts, []) == groups


def test_mesh_orders():
    """Host-major global indices: rank r's device d is r * n_local + d,
    in the pod grid and the flat mesh alike; at one process pod_mesh and
    flat_mesh are the local devices."""
    from umgap_tpu_torch.parallel import ProcessMesh, flat_mesh, pod_mesh

    cpu = torch.device("cpu")
    for rank in range(3):
        pod = ProcessMesh(rank, 3, (cpu,) * 2, (3, 2))
        flat = ProcessMesh(rank, 3, (cpu,) * 2)
        assert flat.shape == (6,) and pod.n_devices == flat.n_devices == 6
        assert [pod.global_index(d) for d in range(2)] == [2 * rank,
                                                          2 * rank + 1]
        assert pod.grid()[rank].tolist() == [2 * rank, 2 * rank + 1]
        assert np.array_equal(pod.grid().ravel(), flat.grid())
    p1 = pod_mesh(local=["cpu"] * 4)
    assert (p1.rank, p1.world_size, p1.shape) == (0, 1, (1, 4))
    assert flat_mesh(device="cpu") == ProcessMesh(0, 1, (cpu,), (1,))
    with pytest.raises(ValueError, match="rank 2 outside"):
        ProcessMesh(2, 2, (cpu,))
    with pytest.raises(ValueError, match="does not hold"):
        ProcessMesh(0, 2, (cpu,), (3,))


class _Spy:
    """A shard that records whether its rows were read."""

    def __init__(self, t, read):
        self._t, self._read = t, read

    def __getattr__(self, name):
        return getattr(self._t, name)

    def packed_rows(self):
        self._read.append(self._t)
        return self._t.packed_rows()


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_from_shards_over_process_mesh(toy, rank):
    """Over a process mesh (rank ``rank`` of 3, 2 devices each) of 12
    shards, local device d holds global device 2 * rank + d's 2 shards
    (first, n_total); only those shards' rows are read. umgap_tpu's
    shards carried across give the port's own rows."""
    from umgap_tpu.ops import lookup as jlookup
    from umgap_tpu.parallel import sharded as jsharded
    from umgap_tpu_torch.index import table as ptable
    from umgap_tpu_torch.parallel import ProcessMesh, ShardedTable
    from umgap_tpu_torch.parallel import build_sharded_tables

    cpu = torch.device("cpu")
    mesh = ProcessMesh(rank, 3, (cpu,) * 2)
    shards = build_sharded_tables(toy["packed"], toy["values"], 9, 12)
    read: list = []
    st = ShardedTable.from_shards([_Spy(t, read) for t in shards], mesh)
    assert st.n_devices == 2 and st.mesh is mesh and st.group == 2
    assert [(t.first, t.n_total) for t in st.tables] == [
        (4 * rank, 12), (4 * rank + 2, 12)]
    assert read == shards[4 * rank:4 * rank + 4]
    js = jsharded.build_sharded_tables(toy["packed"], toy["values"], k=9,
                                       n_shards=12)
    carried = [ptable.KmerTable(
        None, None, t.max_probes, t.n, dict(t.meta), t.stash_hi, t.stash_lo,
        t.stash_val, rows_packed=np.asarray(jlookup.pack_rows(t)))
        for t in js]
    jst = ShardedTable.from_shards(carried, mesh)
    for a, b in zip(st.tables, jst.tables):
        assert torch.equal(a.rows, b.rows) and torch.equal(a.stash, b.stash)


def test_no_card_refused():
    """Without a card and without device="cpu" the mesh, the pipeline
    and an nccl group raise NoCudaDevice (before any rendezvous)."""
    from umgap_tpu_torch.device import NoCudaDevice
    from umgap_tpu_torch.parallel import (
        flat_mesh,
        init_distributed,
        make_multihost_pipeline,
        pod_mesh,
    )
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.taxonomy import Taxonomy, fixture_taxa

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for fn in (pod_mesh, flat_mesh):
        with pytest.raises(NoCudaDevice):
            fn()
    with pytest.raises(NoCudaDevice):
        make_multihost_pipeline(Taxonomy(fixture_taxa()), np.arange(
            1, 9, dtype=np.uint64), np.full(8, 2, np.int32), 9,
            PRESETS["max-sensitivity"])
    with pytest.raises(NoCudaDevice):
        init_distributed(f"tcp://127.0.0.1:{_free_port()}", 2, 0,
                         backend="nccl")
    with pytest.raises(ValueError, match="one of"):
        init_distributed(f"tcp://127.0.0.1:{_free_port()}", 2, 0,
                         backend="mpi")


# ---------------------------------------------------------------------- #
# The worker: one rank (python test_torch_multihost.py MODE PORT RANK
# WORLD N_LOCAL GROUPS IN.npz OUT.npz)
# ---------------------------------------------------------------------- #

def _worker_step(rank, world, n_local, groups, data, init, device):
    import torch.distributed as dist

    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.parallel import (
        allgather_taxa,
        flat_mesh,
        global_batch,
        make_multihost_pipeline,
        make_multihost_tryptic_pipeline,
        per_host_groups,
        pod_mesh,
    )
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS
    from umgap_tpu_torch.taxonomy import Taxonomy, fixture_taxa

    init(backend="gloo")
    local = (device,) * n_local
    mesh = flat_mesh(local=local)
    pod = pod_mesh(local=local)
    assert mesh.n_devices == world * n_local and pod.shape == (world,
                                                                n_local)
    tax = Taxonomy(fixture_taxa())
    config = PRESETS["max-sensitivity"]._replace(k_max=32)
    tconfig = TRYPTIC_PRESETS["tryptic-sensitivity"]._replace(k_max=16)
    mine = per_host_groups(list(range(groups)), rank, world)
    dna = data["dna"][mine]
    lens = data["lengths"][mine]
    out = {"grid": pod.grid()}
    _m, step = make_multihost_pipeline(tax, data["packed"], data["values"],
                                       9, config, mesh=mesh)
    _m, tstep = make_multihost_tryptic_pipeline(
        tax, [str(p) for p in data["peptides"]], data["pvalues"], tconfig,
        mesh=mesh)
    for tag, fn in (("", step), ("t", tstep)):
        d, ln = global_batch(dna, lens, mesh)
        kernels.reset_launches()
        taxa, freq = fn(d, ln, n=len(mine))
        out[tag + "launches"] = np.array(
            [[k, v] for k, v in kernels.launch_counts().items()])
        out[tag + "taxa"] = allgather_taxa(taxa, mesh, n=len(mine))
        out[tag + "freq"] = freq.cpu().numpy()
    dist.destroy_process_group()
    return out


def _worker_nccl(data, init):
    """nccl on one card, the card and the group monkeypatched: every
    rank names the same card, gloo carries the rendezvous."""
    import torch.distributed as dist

    from umgap_tpu_torch.parallel import multihost

    torch.cuda.is_available = lambda: True
    torch.cuda.current_device = lambda: 0
    torch.cuda.set_device = lambda _dev: None
    multihost._card_identity = lambda _dev: ("host", "GPU-0")
    real = multihost._init_group
    multihost._init_group = lambda _b, *a: real("gloo", *a)
    try:
        init(backend="nccl")
    except ValueError as e:
        return {"error": np.array(str(e)),
                "initialized": np.array(dist.is_initialized())}
    raise AssertionError("nccl on one card was not refused")


def _worker(argv):
    mode, port, rank, world, n_local, groups, src, dst = argv
    rank, world, n_local, groups = (int(rank), int(world), int(n_local),
                                    int(groups))
    from umgap_tpu_torch.parallel import init_distributed

    def init(backend):
        init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                         backend=backend)

    data = dict(np.load(src))
    if mode == "nccl":
        out = _worker_nccl(data, init)
    else:
        out = _worker_step(rank, world, n_local, groups, data, init,
                           "cuda:0" if mode == "step-cuda" else "cpu")
    if rank == 0:
        np.savez(dst, **out)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1:])
