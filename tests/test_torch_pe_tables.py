"""The pieces of the port's PE index build against the JAX package's, on
the CPU: ``DeviceRef.t32`` and ``nsep``, the full candidate grid against
``_pe_cvalid`` and the singleton counts against ``_pe_single_chunk`` on
the same rank tables, the compaction of the plain version, the chunk
plan, the port's NumPy PE builder, the sharded build, and what the device
build refuses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emsar_tpu.config import BuildConfig as JaxBuildConfig
from emsar_tpu.config import StrandType as JaxStrandType
from emsar_tpu.index import device_build as jdb
from emsar_tpu.index.build import build_pe_index as jax_build_pe_index
from emsar_tpu.io.fasta import build_transcriptome as jax_transcriptome
from emsar_tpu_torch.index import build as tbuild
from emsar_tpu_torch.index import device_build as tdb
from emsar_tpu_torch.index import device_build_pe as tpe
from emsar_tpu_torch.io.fasta import build_transcriptome
from emsar_tpu_torch.io.rsh import RshIndex
from emsar_tpu_torch.kernels import pe_candidates as kpe
from tests.test_torch_pe_build import _cfg, _rsh_bytes, plans  # noqa: F401
from tests.util import random_transcriptome

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _seqs(seed, n=20, n_frac=0.02, min_len=30, max_len=300):
    return random_transcriptome(np.random.default_rng(seed), n,
                                min_len=min_len, max_len=max_len,
                                n_frac=n_frac, shared_frac=0.6)


@pytest.mark.parametrize("rl", [15, 20, 24])
def test_t32_and_nsep_match_jax(rl):
    names, seqs = _seqs(40)
    tx = build_transcriptome(names, seqs)
    jref = jdb.DeviceRef(jax_transcriptome(names, seqs))
    ref = tdb.DeviceRef(tx, CPU)
    n = tx.seqlength - rl + 1
    t32 = ref.t32(rl)
    assert t32.dtype == torch.int32 and t32.shape == (n,)
    np.testing.assert_array_equal(t32.numpy(), np.asarray(jref.t32(rl))[:n])
    nsep = ref.nsep()
    assert nsep.dtype == torch.int32 and nsep.shape == (tx.seqlength + 1,)
    np.testing.assert_array_equal(
        nsep.numpy(), np.asarray(jref.nsep)[:tx.seqlength + 1])
    sep = np.flatnonzero((tx.seq == ord("@")) | (tx.seq == ord("$")))
    np.testing.assert_array_equal(
        nsep.numpy(), sep[np.searchsorted(sep, np.arange(tx.seqlength + 1))])


@pytest.mark.parametrize("fmin,fmax", [(1, 60), (45, 70)],
                         ids=["d0_0", "d0_pos"])
@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_candidates_match_jax_cvalid(strand, fmin, fmax):
    """The full grid on the JAX rank pass's own tables (R, RF, t32, nsep
    as numpy) against ``_pe_cvalid``: the same validity, mate2 ranks and
    payloads for mate1 positions of both halves."""
    names, seqs = _seqs(41)
    jtx = jax_transcriptome(names, seqs)
    two = strand == "ns"
    rl = 20
    fl_min = max(fmin, rl)
    nfl, d0 = fmax - fl_min + 1, fl_min - rl
    cfg = JaxBuildConfig(pe=True, strand=JaxStrandType.parse(strand, True),
                         min_fraglength=fmin, max_fraglength=fmax, verbose=0)
    jref = jdb.DeviceRef(jtx)
    spos, rank, _, n_valid, R, _ = jdb._pe_rank_hashsort(jtx, jref, rl, two,
                                                         cfg)
    T32, NS = jref.t32(rl), jref.nsep
    R_np = np.asarray(R).copy()
    sl, bp = int(jtx.seqlength), int(jtx.borderpos)
    n_rank = sl - rl + 1
    RW, RF32 = jdb._pe_prep_tables(R, Lp=jref.Lp, nv=n_rank, two=two)
    spos = np.asarray(spos)[:n_valid].astype(np.int32)
    rank = np.asarray(rank)[:n_valid].astype(np.int32)
    assert (spos > bp).any() == two
    pick = np.random.default_rng(3).choice(n_valid, 400, replace=False)
    mpos, mrank = spos[pick], rank[pick]
    cvalid, rw, tidm = jdb._pe_cvalid(
        jnp.asarray(mpos), jnp.asarray(mrank), RW, RF32, T32, NS,
        jnp.int32(d0), nfl, two, bp, sl, rl, jref.Lp)
    cvalid = np.asarray(cvalid)

    def t(a, n):
        return torch.as_tensor(np.asarray(a)[:n].astype(np.int32))

    keys, pay = kpe.pe_candidate_grid_ref(
        torch.as_tensor(mpos), torch.as_tensor(mrank), t(R_np, n_rank),
        t(RF32, n_rank) if two else None, t(T32, n_rank), t(NS, sl + 1), d0,
        nfl, rl, bp, sl, two)
    keys, pay = keys.numpy().reshape(-1, nfl), pay.numpy().reshape(-1, nfl)
    valid = keys != kpe.INVALID_KEY
    assert 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(valid, cvalid)
    np.testing.assert_array_equal((keys & ((1 << 30) - 1))[valid],
                                  np.asarray(rw).astype(np.int64)[valid])
    np.testing.assert_array_equal(keys[valid] >> 30,
                                  np.broadcast_to(mrank[:, None],
                                                  keys.shape)[valid])
    np.testing.assert_array_equal(pay >> 9, np.broadcast_to(
        np.asarray(tidm)[:, None], pay.shape))
    np.testing.assert_array_equal(pay & 0x1FF, np.broadcast_to(
        np.arange(nfl), pay.shape))


@pytest.mark.parametrize("fmin,fmax", [(1, 60), (45, 70)],
                         ids=["d0_0", "d0_pos"])
@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_singleton_counts_match_jax_single_chunk(strand, fmin, fmax):
    """The plain version's singleton counts on the JAX rank pass's own
    tables equal ``_pe_single_chunk``'s ``dense_s`` over the singleton
    members ``_pe_partition_clusters`` picks."""
    names, seqs = _seqs(46)
    jtx = jax_transcriptome(names, seqs)
    two = strand == "ns"
    rl = 20
    fl_min = max(fmin, rl)
    nfl, d0 = fmax - fl_min + 1, fl_min - rl
    cfg = JaxBuildConfig(pe=True, strand=JaxStrandType.parse(strand, True),
                         min_fraglength=fmin, max_fraglength=fmax, verbose=0)
    jref = jdb.DeviceRef(jtx)
    spos, rank, _, n_valid, R, _ = jdb._pe_rank_hashsort(jtx, jref, rl, two,
                                                         cfg)
    spos, rank = np.asarray(spos).copy(), np.asarray(rank).copy()
    T32, NS = jref.t32(rl), jref.nsep
    R_np = np.asarray(R).copy()
    sl, bp = int(jtx.seqlength), int(jtx.borderpos)
    n_rank = sl - rl + 1
    ntid = jtx.n_transcripts
    RW, RF32 = jdb._pe_prep_tables(R, Lp=jref.Lp, nv=n_rank, two=two)
    SPs, RKs, _, _, ns, _ = jdb._pe_partition_clusters(
        jnp.asarray(spos), jnp.asarray(rank), jnp.int32(n_valid))
    assert 0 < int(ns) < n_valid
    want = jdb._pe_single_chunk(
        jnp.zeros(ntid * nfl, jnp.int32), SPs, RKs, RW, RF32, T32, NS,
        jnp.int32(0), jnp.int32(d0), Ss=int(SPs.shape[0]), nfl=nfl,
        unstranded=two, borderpos=bp, seqlength=sl, readlength=rl,
        Lp=jref.Lp)

    def t(a, n):
        return torch.as_tensor(np.asarray(a)[:n].astype(np.int32))

    single = torch.zeros(ntid * nfl, dtype=torch.int64)
    kpe.pe_candidates_ref(
        t(spos, n_valid), t(rank, n_valid), 0, int(n_valid), t(R_np, n_rank),
        t(RF32, n_rank) if two else None,
        kpe.pack_tables(t(T32, n_rank), t(NS, sl + 1)), d0, nfl, rl, bp, sl,
        two, single)
    want = np.asarray(want).astype(np.int64)
    assert want.sum() > 0
    np.testing.assert_array_equal(single.numpy(), want)


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_plain_version_compacts_the_grid(strand):
    """The plain version's candidates are the full grid's valid
    candidates of the multi-member clusters' members, member-major, and
    its singleton counts are what the grid's singleton rows resolve to;
    a chunk that cuts a cluster keeps the cut members out of the
    singleton path."""
    names, seqs = _seqs(47, n=15, n_frac=0.0)
    tx = build_transcriptome(names, seqs)
    rl, nfl, d0 = 18, 30, 5
    two = strand == "ns"
    ref = tdb.DeviceRef(tx, CPU)
    t32, nsep = ref.t32(rl), ref.nsep()
    R, spos, srank = tpe.rank_pass(ref, t32, rl, two, 0)
    RF = R.flip(0).contiguous() if two else None
    tn = kpe.pack_tables(t32, nsep)
    t32_, nsep_ = kpe.unpack_tables(tn)
    assert torch.equal(t32_[:t32.shape[0]], t32) and torch.equal(nsep_, nsep)
    assert not t32_[t32.shape[0]:].any()
    tail = (d0, nfl, rl, tx.borderpos, tx.seqlength, two)
    n = spos.shape[0]
    first = torch.nonzero(srank[1:] != srank[:-1]).squeeze(1) + 1
    sizes = torch.diff(first)
    lo = int(first[torch.nonzero(sizes > 1)[3]]) + 1  # inside a cluster
    for a, b in ((0, n), (lo, n - 7)):
        single = torch.zeros(tx.n_transcripts * nfl, dtype=torch.int64)
        keys, pay = kpe.pe_candidates_ref(spos, srank, a, b, R, RF, tn, *tail,
                                          single)
        gk, gp = kpe.pe_candidate_grid_ref(spos[a:b], srank[a:b], R, RF, t32,
                                           nsep, *tail)
        gk, gp = gk.view(-1, nfl), gp.view(-1, nfl)
        sng = kpe.singleton_members(srank, a, b)
        whole = kpe.singleton_members(srank, 0, n)[a:b]
        assert torch.equal(sng, whole) and 0 < int(sng.sum()) < b - a
        valid = (gk != kpe.INVALID_KEY) & ~sng[:, None]
        assert torch.equal(keys, gk[valid]) and torch.equal(pay, gp[valid])
        # the singleton rows' keys are their own: a key of one candidate
        # is a size-1 run of the global sort
        sk, sp = gk[sng], gp[sng].to(torch.int64)
        ok = sk != kpe.INVALID_KEY
        _, inv, cnt = torch.unique(sk[ok], return_inverse=True,
                                   return_counts=True)
        one = sp[ok][cnt[inv] == 1]
        want = torch.bincount((one >> 9) * nfl + (one & 0x1FF),
                              minlength=single.shape[0])
        assert int(want.sum()) > 0 and torch.equal(single, want)
        with pytest.raises(RuntimeError, match="exceed the capacity"):
            kpe.pe_candidates_ref(spos, srank, a, b, R, RF, tn, *tail, single,
                                  capacity=keys.shape[0] - 1)


@pytest.mark.parametrize("kind", ["mixed", "singletons"])
@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_plain_version_slices_the_grid(strand, kind, monkeypatch):
    """The plain version expands at most ``REF_SLICE_CELLS`` grid cells at
    once, also on a chunk of singleton members only (which the chunk plan
    weighs at one a member), and gives what one expansion of the whole
    chunk gives: candidates, their order and the singleton counts."""
    names, seqs = _seqs(49, n=15, n_frac=0.0)
    tx = build_transcriptome(names, seqs)
    rl, nfl, d0 = 18, 30, 5
    two = strand == "ns"
    ref = tdb.DeviceRef(tx, CPU)
    t32, nsep = ref.t32(rl), ref.nsep()
    R, spos, srank = tpe.rank_pass(ref, t32, rl, two, 0)
    if kind == "singletons":
        sng = kpe.singleton_members(srank, 0, srank.shape[0])
        spos, srank = spos[sng], srank[sng]
    args = (spos, srank, 3, spos.shape[0] - 2, R,
            R.flip(0).contiguous() if two else None,
            kpe.pack_tables(t32, nsep), d0, nfl, rl, tx.borderpos,
            tx.seqlength, two)
    whole = torch.zeros(tx.n_transcripts * nfl, dtype=torch.int64)
    want = kpe.pe_candidates_ref(*args, whole)
    assert int(whole.sum()) > 0 and (want[0].shape[0] > 0) == (kind == "mixed")
    cells, grid = [], kpe.pe_candidate_grid_ref

    def counted(mpos, *rest):
        cells.append(mpos.shape[0] * nfl)
        return grid(mpos, *rest)

    monkeypatch.setattr(kpe, "REF_SLICE_CELLS", 7 * nfl + 3)
    monkeypatch.setattr(kpe, "pe_candidate_grid_ref", counted)
    single = torch.zeros_like(whole)
    got = kpe.pe_candidates_ref(*args, single)
    assert len(cells) > 10 and max(cells) <= 7 * nfl
    assert sum(cells) == (args[3] - args[2]) * nfl
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(single, whole)


@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ssfr"])
def test_bytes_moved_counts_what_the_kernel_needs(unstranded):
    """The kernel's bound: 16 B a member, 4 B per R entry (and RF entry)
    the windows cover together, 12 B per written candidate and 16 B per
    changed entry of ``single``; the parent's grid bound adds RF[p] and
    writes every cell."""
    rng = np.random.default_rng(50)
    nfl = 11
    mpos = torch.as_tensor(rng.integers(0, 5000, 300).astype(np.int32))
    covered = np.unique(mpos.numpy()[:, None] + np.arange(nfl)).size
    u = 2 if unstranded else 1
    M = mpos.shape[0]
    assert kpe.bytes_moved(mpos, nfl, unstranded, 1234, 56) == (
        16 * M + 4 * covered * u + 12 * 1234 + 16 * 56)
    assert kpe.bytes_moved_grid(mpos, nfl, unstranded) == (
        (16 + 4 * (u - 1)) * M + 4 * covered * u + 12 * M * nfl)
    empty = mpos[:0]
    assert kpe.bytes_moved(empty, nfl, unstranded, 0, 0) == 0
    assert kpe.bytes_moved_grid(empty, nfl, unstranded) == 0


def test_plan_chunks_weighs_singletons_lightly():
    """Chunks are runs of whole clusters; a multi-member cluster weighs
    nfl a member, a singleton one; each chunk weighs at most the budget,
    and the next cluster would not fit; a cluster over the budget is
    refused."""
    rng = np.random.default_rng(48)
    sizes = rng.choice([1, 1, 1, 2, 3, 6], 400)
    srank = torch.as_tensor(np.repeat(np.arange(400), sizes).astype(np.int32))
    nfl, budget = 7, 100
    bounds = tpe.plan_chunks(srank, nfl, budget)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    weight = np.where(sizes > 1, sizes * nfl, tpe.SINGLETON_WEIGHT)
    assert bounds[0][0] == 0 and bounds[-1][1] == starts[-1]
    for (lo, hi, w), nxt in zip(bounds, bounds[1:] + [None]):
        c0, c1 = np.searchsorted(starts, [lo, hi])
        assert starts[c0] == lo and starts[c1] == hi
        assert w == weight[c0:c1].sum() <= budget
        if nxt is not None:
            assert nxt[0] == hi and w + weight[c1] > budget
    assert len(bounds) < (sizes * nfl).sum() // budget
    assert tpe.plan_chunks(torch.arange(50, dtype=torch.int32), nfl, 10) \
        == [(k, k + 10, 10) for k in range(0, 50, 10)]
    with pytest.raises(ValueError, match="more than the chunk budget"):
        tpe.plan_chunks(srank, nfl, 6 * nfl - 1)
    assert tpe.plan_chunks(srank[:0], nfl, budget) == []


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_numpy_pe_builder_matches_jax(strand, tmp_path):
    names, seqs = _seqs(42, n=12)
    cfg = JaxBuildConfig(pe=True, strand=JaxStrandType.parse(strand, True),
                         min_fraglength=1, max_fraglength=55, verbose=0)
    want = jax_build_pe_index(jax_transcriptome(names, seqs), 18, cfg,
                              backend="numpy")
    got = tbuild.build_pe_index(build_transcriptome(names, seqs), 18,
                                _cfg(strand, 1, 55), backend="numpy")
    assert got.n_multi > 0
    assert (_rsh_bytes(got, tmp_path / "t.rsh")
            == _rsh_bytes(want, tmp_path / "j.rsh"))


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_sharded_pe_build_merges_to_the_whole(strand, tmp_path, monkeypatch,
                                              plans):
    """Partials of shard=(i, 3), merged with RshIndex.merge, give the
    bytes of the whole build: every chunk of whole mate1 clusters is
    counted by exactly one shard."""
    names, seqs = _seqs(43, n=15, n_frac=0.0, min_len=60, max_len=200)
    tx = build_transcriptome(names, seqs)
    cfg = _cfg(strand, 1, 60)
    whole = tbuild.build_pe_index(tx, 18, cfg, device="cpu")
    monkeypatch.setattr(tpe, "CHUNK_CANDIDATES", 43 * 40)
    parts = [tbuild.build_pe_index(tx, 18, cfg, device="cpu", shard=(i, 3))
             for i in range(3)]
    assert len(plans[-1]) >= 6
    assert all(p.n_multi > 0 for p in parts)
    assert (_rsh_bytes(RshIndex.merge(parts), tmp_path / "m.rsh")
            == _rsh_bytes(whole, tmp_path / "w.rsh"))


def test_pe_build_refusals(monkeypatch):
    names, seqs = _seqs(44, n=8, n_frac=0.0)
    tx = build_transcriptome(names, seqs)
    with pytest.raises(ValueError, match="fewer than 512"):
        tbuild.build_pe_index(tx, 20, _cfg("ns", 1, 600), device="cpu")
    with pytest.raises(ValueError, match="read length 1100"):
        tbuild.build_pe_index(tx, 1100, _cfg("ns", 1, 60), device="cpu")
    with pytest.raises(ValueError, match="needs the device backend"):
        tbuild.build_pe_index(tx, 20, _cfg("ns", 1, 60), backend="numpy",
                              shard=(0, 2))
    # a cluster of two identical transcripts' windows needs 2 x 41
    # candidates
    dup = build_transcriptome(names + ["copy"], seqs + [seqs[0]])
    monkeypatch.setattr(tpe, "CHUNK_CANDIDATES", 41)
    with pytest.raises(ValueError, match="more than the chunk budget"):
        tbuild.build_pe_index(dup, 20, _cfg("ssfr", 1, 60), device="cpu")


def test_print_sfa_takes_the_numpy_builder(tmp_path, monkeypatch, capsys):
    names, seqs = _seqs(45, n=8)
    tx = build_transcriptome(names, seqs)

    def no_device(*a, **k):
        raise AssertionError("the device builder was called")

    monkeypatch.setattr(tpe, "build_pe_index_device", no_device)
    sfa = tmp_path / "x.sfa"
    cfg = _cfg("ns", 1, 50)
    cfg.verbose = 1
    got = tbuild.build_pe_index(tx, 16, cfg, sfa_path=str(sfa), device="cpu")
    assert "-T/--print_sfa requested" in capsys.readouterr().err
    assert sfa.read_text().startswith("0\t")
    want = tbuild.build_pe_index(tx, 16, cfg, backend="numpy")
    assert (_rsh_bytes(got, tmp_path / "a.rsh")
            == _rsh_bytes(want, tmp_path / "b.rsh"))
