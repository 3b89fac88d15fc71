"""The pieces of the port's PE index build against the JAX package's, on
the CPU: ``DeviceRef.t32`` and ``nsep``, ``pe_candidates_ref`` against
``_pe_cvalid`` on the same rank tables, the port's NumPy PE builder, the
sharded build, and what the device build refuses."""

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
    """The plain version on the JAX rank pass's own tables (R, RF, t32,
    nsep as numpy) against ``_pe_cvalid``: the same validity, mate2 ranks
    and payloads for mate1 positions of both halves."""
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

    keys, pay = kpe.pe_candidates_ref(
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
