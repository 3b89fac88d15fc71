"""The port's device SE index build against the JAX package's, on the CPU
(the kernels' plain versions): the hash lanes bit for bit against
``_se_hash_slab``, and the ``.rsh`` bytes against
``emsar_tpu.index.build.build_se_index`` (its device backend)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emsar_tpu.config import BuildConfig, StrandType
from emsar_tpu.index import device_build as jdb
from emsar_tpu.index.build import build_se_index as jax_build_se_index
from emsar_tpu.index.kernels import _MULT
from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu.sim import gene_family_transcriptome
from emsar_tpu_torch.index import build as tbuild
from emsar_tpu_torch.index import device_build as tdb
from emsar_tpu_torch.kernels import window_hash as kwh
from emsar_tpu_torch.kernels.window_hash import MULT, _words, window_hash
from tests.util import random_transcriptome

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _tx(seed, n_tx=40, n_frac=0.0, dup=0):
    rng = np.random.default_rng(seed)
    names, seqs = random_transcriptome(rng, n_tx, shared_frac=0.6,
                                       n_frac=n_frac)
    for k in range(dup):
        # whole-transcript copies: long runs of identical windows
        names.append(f"D{k:04d}")
        seqs.append(seqs[k % 3])
    return build_transcriptome(names, seqs)


def test_multipliers_are_the_jax_packages():
    np.testing.assert_array_equal(MULT, _MULT)


@pytest.mark.parametrize("strand", ["ns", "ssf"])
@pytest.mark.parametrize("rl", [15, 16, 20, 32, 33, 64])
def test_window_hash_matches_jax(rl, strand):
    """Lanes and tids of every forward window, bit for bit, through a JAX
    DeviceRef and one hash slab over the whole forward half."""
    tx = _tx(3, n_frac=0.02)
    unstranded = strand == "ns"
    ref = jdb.DeviceRef(tx)
    bp, sl = int(tx.borderpos), int(tx.seqlength)
    n = bp - rl + 1
    slab = jdb._next_pow2(n)
    tidf = jdb._tid_forward(ref.cuml, size=slab)
    out = jdb._se_hash_slab(
        *(jnp.zeros(slab, jnp.uint32) for _ in range(3)),
        jnp.full(slab, -1, jnp.int32), ref._packed, ref._badbits, tidf,
        jnp.int32(0), jnp.int32(bp), jnp.int32(sl), slab=slab,
        unstranded=unstranded, readlength=rl)
    want = [np.asarray(a)[:n].view(np.int32) for a in out[:4]]
    dref = tdb.DeviceRef(tx, CPU)
    got = window_hash(dref.codes, dref.tid_forward(n), bp, sl, rl,
                      unstranded)
    assert int((got[3] >= 0).sum()) == int(out[4]) > 0
    assert (got[3] < 0).any()  # the N bases and separators
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def _packed(codes: np.ndarray, mis: int):
    """What csrc/window_hash.cu stages: the codes from ``mis`` positions
    before base 0 (the 16-byte alignment), 16 to a big-endian 2-bit word,
    and the count of non-ACGT codes before each word."""
    pad = np.concatenate([np.full(mis, 4, np.uint8), codes,
                          np.full(32, 4, np.uint8)])
    nw = len(pad) // 16
    by = pad[:16 * nw].reshape(nw, 16).astype(np.uint64)
    shifts = 2 * np.arange(15, -1, -1, dtype=np.uint64)
    words = ((by & 3) << shifts).sum(axis=1)
    bad = by >= 4
    pre = np.concatenate([[0], np.cumsum(bad.sum(axis=1))])[:nw]
    return words, bad, pre


def _funnel_word(words, pos, nb):
    """The nb-base word at each position: the upper 32 bits of packed word
    pos // 16 and the next, shifted left by 2 (pos % 16) bits (CUDA's
    __funnelshift_l), then shifted down for a partial word."""
    q, s = pos >> 4, (pos & 15).astype(np.uint64)
    both = (words[q] << np.uint64(32)) | words[q + 1]
    w = (both << (np.uint64(2) * s)) >> np.uint64(32)
    return w >> np.uint64(2 * (16 - nb)) if nb < 16 else w


@pytest.mark.parametrize("mis", [0, 5])
@pytest.mark.parametrize("rl", [1, 16, 17, 32, 64, 76])
def test_funnel_shift_words_match_plain_words(rl, mis):
    """The window hash kernel's words and validity: a window's fw and rc
    words taken by funnel shifts from 2-bit-packed words equal the plain
    version's ``_words``, and the prefix count of non-ACGT codes at the
    window's ends gives its validity."""
    tx = _tx(5, n_frac=0.02)
    codes = tdb.DeviceRef(tx, CPU).codes
    bp, sl = int(tx.borderpos), int(tx.seqlength)
    n = bp - rl + 1
    words, bad, pre = _packed(codes.numpy(), mis)
    c3 = codes.to(torch.int64) & 3
    i = np.arange(n)
    fw = _words(c3, 0, n, rl, flip=False)
    rc = _words(c3, sl - rl, n, rl, flip=True)
    for w in range(len(fw)):
        nb = min(16, rl - 16 * w)
        np.testing.assert_array_equal(
            _funnel_word(words, mis + i + 16 * w, nb), fw[w].numpy())
        np.testing.assert_array_equal(
            _funnel_word(words, mis + sl - i - rl + 16 * w, nb), rc[w].numpy())

    def count(x):
        return pre[x >> 4] + (bad[x >> 4] & (np.arange(16) < (x & 15)[:, None])
                              ).sum(axis=1)

    valid = count(mis + i + rl) == count(mis + i)
    lanes = window_hash(codes, tdb.DeviceRef(tx, CPU).tid_forward(n), bp, sl,
                        rl, True)
    np.testing.assert_array_equal(valid, lanes[3].numpy() >= 0)
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("unstranded", [True, False])
def test_bytes_moved_counts_the_codes_read(unstranded):
    """The bound's code bytes are the codes the windows read: scrambling
    every other code leaves the output as it was."""
    tx = _tx(6, n_frac=0.02)
    ref = tdb.DeviceRef(tx, CPU)
    bp, sl, rl = int(tx.borderpos), int(tx.seqlength), 20
    n = bp - rl + 1
    read = np.zeros(sl + 1, bool)
    read[:bp] = True
    if unstranded:
        read[sl - bp:sl] = True
    assert kwh.bytes_moved(bp, rl, unstranded) == read.sum() + 20 * n
    codes = ref.codes.clone()
    rng = np.random.default_rng(6)
    codes[torch.as_tensor(~read)] = torch.as_tensor(
        rng.integers(0, 5, int((~read).sum()), dtype=np.uint8))
    tidf = ref.tid_forward(n)
    for g, w in zip(window_hash(codes, tidf, bp, sl, rl, unstranded),
                    window_hash(ref.codes, tidf, bp, sl, rl, unstranded)):
        assert torch.equal(g, w)


def test_tid_forward_matches_transcript_of():
    tx = _tx(4)
    n = int(tx.borderpos)
    got = tdb.DeviceRef(tx, CPU).tid_forward(n).numpy()
    want = np.searchsorted(tx.cuml, np.arange(n), side="right") - 1
    np.testing.assert_array_equal(got, want)


CASES = {
    # name: (seed, n_tx, n_frac, strand, rl_min, rl_max, max_repeat, dup)
    "unstranded": (20, 40, 0.0, "ns", 20, 20, 100, 0),
    "stranded": (21, 40, 0.0, "ssf", 18, 18, 100, 0),
    "with_N": (22, 40, 0.02, "ns", 16, 16, 100, 0),
    "readlength_range": (23, 30, 0.0, "ns", 18, 21, 100, 0),
    "radix_chunked": (24, 60, 0.0, "ns", 20, 20, 100, 0),
    "max_repeat_drops": (25, 40, 0.0, "ns", 20, 20, 3, 0),
    "duplicated_transcripts": (26, 30, 0.0, "ns", 20, 20, 100, 12),
    "stranded_range_dups": (27, 30, 0.01, "ssr", 15, 17, 5, 6),
}


def _rsh_bytes(index, path):
    index.write_text(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_build_rsh_byte_identical(case, tmp_path):
    seed, n_tx, n_frac, strand, lo, hi, max_repeat, dup = CASES[case]
    tx = _tx(seed, n_tx, n_frac, dup)
    cfg = BuildConfig(verbose=0, strand=StrandType.parse(strand, False),
                      max_repeat=max_repeat)
    want = jax_build_se_index(tx, lo, hi, cfg)
    got = tbuild.build_se_index(tx, lo, hi, cfg, backend="device",
                                device="cpu")
    assert got.n_multi > 0
    assert (_rsh_bytes(got, tmp_path / "torch.rsh")
            == _rsh_bytes(want, tmp_path / "jax.rsh"))


def test_device_build_gene_family(tmp_path):
    """Exon/isoform sharing, the regime of real transcriptomes."""
    rng = np.random.default_rng(31)
    names, seqs, _ = gene_family_transcriptome(rng, 25, n_exons=5,
                                               min_exon=40, max_exon=120)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(verbose=0)
    want = jax_build_se_index(tx, 25, 25, cfg)
    got = tbuild.build_se_index(tx, 25, 25, cfg, backend="device",
                                device="cpu")
    assert got.n_multi > 10
    assert (_rsh_bytes(got, tmp_path / "torch.rsh")
            == _rsh_bytes(want, tmp_path / "jax.rsh"))


def test_signature_hash_collisions_split_exactly(tmp_path, monkeypatch):
    """With every multiset hashed alike, groups rest on size alone and the
    exact check against the exemplar must split them: same bytes."""
    tx = _tx(28, dup=6)
    cfg = BuildConfig(verbose=0)
    want = tbuild.build_se_index(tx, 18, 19, cfg, backend="numpy")

    def flat_keys(flat, sizes):
        return [torch.zeros_like(sizes), sizes << 32]

    monkeypatch.setattr(tdb, "_signature_keys", flat_keys)
    got = tbuild.build_se_index(tx, 18, 19, cfg, backend="device",
                                device="cpu")
    assert got.n_multi > 5
    assert (_rsh_bytes(got, tmp_path / "torch.rsh")
            == _rsh_bytes(want, tmp_path / "numpy.rsh"))


def test_backend_selection(tmp_path, monkeypatch, capsys):
    tx = _tx(29, n_tx=15)
    cfg = BuildConfig(verbose=1)

    def no_device(*a, **k):
        raise AssertionError("the device builder was called")

    monkeypatch.setattr(tdb, "build_se_index_device", no_device)
    monkeypatch.setenv(tbuild.BACKEND_ENV, "numpy")
    want = tbuild.build_se_index(tx, 20, 20, cfg)
    monkeypatch.delenv(tbuild.BACKEND_ENV)
    sfa = tmp_path / "x.sfa"
    got = tbuild.build_se_index(tx, 20, 20, cfg, sfa_path=str(sfa),
                                device="cpu")
    assert "-T/--print_sfa requested" in capsys.readouterr().err
    assert sfa.read_text().startswith("0\t")
    assert (_rsh_bytes(got, tmp_path / "a.rsh")
            == _rsh_bytes(want, tmp_path / "b.rsh"))
    with pytest.raises(AssertionError, match="device builder was called"):
        tbuild.build_se_index(tx, 20, 20, cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown SE build backend"):
        tbuild.build_se_index(tx, 20, 20, cfg, backend="jax")
