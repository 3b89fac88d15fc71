"""The port's copies of the JAX package's host stages against their
originals, on the same seeded inputs: every case must give equal bytes or
exactly equal arrays.  The copies are ``emsar_tpu_torch/{config, sim,
utils/timing, io/*, ingest/*, model/modules, index/pack, cli/common}`` and
``emsar_tpu_torch/csrc/{ingest,solver}.cc``."""

import dataclasses
import os

import numpy as np
import pytest

from emsar_tpu import config as jconfig
from emsar_tpu import sim as jsim
from emsar_tpu.ingest import collapse as jcollapse
from emsar_tpu.ingest import native as jnative
from emsar_tpu.index import pack as jpack
from emsar_tpu.io import bam as jbam
from emsar_tpu.io import bowtie as jbowtie
from emsar_tpu.io import fasta as jfasta
from emsar_tpu.io import outputs as joutputs
from emsar_tpu.io import rsh as jrsh
from emsar_tpu.io import sam as jsam
from emsar_tpu.model import modules as jmodules
from emsar_tpu.utils import timing as jtiming
from emsar_tpu_torch import config as tconfig
from emsar_tpu_torch import sim as tsim
from emsar_tpu_torch.cli import common as tcommon
from emsar_tpu_torch.index import pack as tpack
from emsar_tpu_torch.index.build import build_se_index
from emsar_tpu_torch.ingest import collapse as tcollapse
from emsar_tpu_torch.ingest import native as tnative
from emsar_tpu_torch.io import bam as tbam
from emsar_tpu_torch.io import bowtie as tbowtie
from emsar_tpu_torch.io import fasta as tfasta
from emsar_tpu_torch.io import outputs as toutputs
from emsar_tpu_torch.io import rsh as trsh
from emsar_tpu_torch.io import sam as tsam
from emsar_tpu_torch.model import modules as tmodules
from emsar_tpu_torch.utils import timing as ttiming
from tests.aligner import align_se, bowtie_lines_se

RL = 20


def _fields(obj) -> dict:
    """A dataclass's fields (properties of RshIndex-like objects aside)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if not f.name.startswith("_")}


def _assert_same(a, b):
    """Equal values: arrays exactly (dtype included), the rest by ==."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif dataclasses.is_dataclass(a):
        fa, fb = _fields(a), _fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            _assert_same(fa[k], fb[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A gene-family transcriptome (FASTA), its SE l20 index (.rsh), and
    SE reads aligned as bowtie, SAM and BAM files."""
    d = tmp_path_factory.mktemp("host")
    rng = np.random.default_rng(2024)
    names, seqs, _ = tsim.gene_family_transcriptome(
        rng, 6, n_exons=4, min_exon=40, max_exon=90)
    fa = str(d / "t.fa")
    with open(fa, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\n{s.decode()}\n")
    tx = tfasta.build_transcriptome(names, seqs)
    index = build_se_index(tx, RL, RL, tconfig.BuildConfig(verbose=0),
                           backend="numpy")
    rsh = str(d / "t.rsh")
    index.write_text(rsh)
    pos = tsim.simulate_fragments(tx, RL, 400, rng)
    rnames, r1, _ = tsim.fragments_to_reads(tx, pos, RL, RL, pe=False)
    files = {fmt: str(d / f"a.{fmt}") for fmt in ("bowtie", "sam", "bam")}
    recs = []
    name_to_ref = {n: i for i, n in enumerate(names)}
    with open(files["bowtie"], "w") as fh:
        for rid, read in zip(rnames, r1):
            for ln in bowtie_lines_se(rid, read, names, seqs):
                fh.write(ln + "\n")
            for strand, tname, p in align_se(read, names, seqs):
                recs.append((rid, 0x10 if strand == "-" else 0,
                             name_to_ref[tname], p,
                             read if strand == "+" else
                             tfasta.revcomp_bytes(read), str(RL)))
    lengths = [len(s) for s in seqs]
    tbam.write_bam(files["bam"], names, lengths, iter(recs))
    with open(files["sam"], "w") as fh:
        for n, ln in zip(names, lengths):
            fh.write(f"@SQ\tSN:{n}\tLN:{ln}\n")
        for qname, flag, ref_id, p, seq, md in recs:
            fh.write(f"{qname}\t{flag}\t{names[ref_id]}\t{p + 1}\t255\t"
                     f"{len(seq)}M\t*\t0\t0\t{seq.decode()}\t*\tMD:Z:{md}\n")
    return {"dir": d, "names": names, "seqs": seqs, "fa": fa, "rsh": rsh,
            "aln": files, "records": recs}


@pytest.mark.parametrize("name", ["BuildConfig", "QuantConfig", "constants",
                                  "StrandType"])
def test_config(name):
    if name == "constants":
        for c in ("MAX_NTID_PER_SID", "EUMACUT_INCREMENT",
                  "INIT_RSHBUCKET_MAX_T_SIZE", "MAX_N_ALNFILES"):
            assert getattr(tconfig, c) == getattr(jconfig, c)
    elif name == "StrandType":
        for pe, s in ((False, "ns"), (False, "ssf"), (False, "ssr"),
                      (True, "ns"), (True, "ssfr"), (True, "ssrf")):
            a = jconfig.StrandType.parse(s, pe)
            b = tconfig.StrandType.parse(s, pe)
            assert (a.name, a.code, a.stranded) == (b.name, b.code,
                                                    b.stranded)
        with pytest.raises(ValueError):
            tconfig.StrandType.parse("ssf", True)
    else:
        # the port's own field: the form of the solves' likelihood gain,
        # the repaired one by default (tconfig.QuantConfig.solver_gain)
        port = dataclasses.asdict(getattr(tconfig, name)())
        if name == "QuantConfig":
            assert port.pop("solver_gain") == "repaired"
        assert dataclasses.asdict(getattr(jconfig, name)()) == port


@pytest.mark.parametrize("draw", ["gene_family", "fragments", "reads"])
def test_sim_draws(draw):
    seed = 31
    j = jsim.gene_family_transcriptome(np.random.default_rng(seed), 5)
    t = tsim.gene_family_transcriptome(np.random.default_rng(seed), 5)
    if draw == "gene_family":
        assert j == t
        return
    tx_j = jfasta.build_transcriptome(*j[:2])
    tx_t = tfasta.build_transcriptome(*t[:2])
    pj = jsim.simulate_fragments(tx_j, 30, 500, np.random.default_rng(seed))
    pt = tsim.simulate_fragments(tx_t, 30, 500, np.random.default_rng(seed))
    _assert_same(pj, pt)
    if draw == "reads":
        assert jsim.fragments_to_reads(tx_j, pj, 12, 30, pe=True) == \
            tsim.fragments_to_reads(tx_t, pt, 12, 30, pe=True)


@pytest.mark.parametrize("header_fmt", ["E", "R"])
def test_fasta_parse(world, header_fmt):
    j = jfasta.read_fasta(world["fa"], header_fmt)
    t = tfasta.read_fasta(world["fa"], header_fmt)
    _assert_same(j, t)
    assert j.transcript_lengths().tolist() == t.transcript_lengths().tolist()
    for s in world["seqs"][:3]:
        assert jfasta.revcomp_bytes(s) == tfasta.revcomp_bytes(s)


def test_pack(world):
    tx = tfasta.read_fasta(world["fa"], "E")
    p16 = tpack.pack16(tx.codes)
    bad = tpack.bad_prefix(tx.codes)
    _assert_same(jpack.pack16(tx.codes), p16)
    _assert_same(jpack.bad_prefix(tx.codes), bad)
    pos = np.arange(0, tx.borderpos - RL + 1, dtype=np.int64)
    valid = tpack.valid_windows(bad, pos, RL)
    _assert_same(jpack.valid_windows(bad, pos, RL), valid)
    pos = pos[valid]
    fw = tpack.window_words_np(p16, pos, RL)
    _assert_same(jpack.window_words_np(p16, pos, RL), fw)
    rc = tpack.window_words_np(p16, tx.seqlength - pos - RL, RL)
    _assert_same(jpack.lexmin_words_np(fw, rc), tpack.lexmin_words_np(fw, rc))
    _assert_same(jpack.lexcmp_words_np(fw, rc), tpack.lexcmp_words_np(fw, rc))
    assert jpack.n_words(76) == tpack.n_words(76)


@pytest.mark.parametrize("form", ["text", "npz"])
def test_rsh_roundtrip(world, form):
    """.rsh load, then write: the same bytes from both modules."""
    src = world["rsh"]
    if form == "npz":
        src = str(world["dir"] / "t.rsh.npz")
        trsh.RshIndex.load(world["rsh"]).write_npz(src)
    out = {}
    for label, mod in (("jax", jrsh), ("torch", trsh)):
        idx = mod.RshIndex.load(src)
        out[label] = str(world["dir"] / f"{label}.{form}.rsh")
        idx.write_text(out[label])
    with open(out["jax"], "rb") as a, open(out["torch"], "rb") as b, \
            open(world["rsh"], "rb") as c:
        ja, tb, orig = a.read(), b.read(), c.read()
    assert ja == tb == orig


def _python_counts(mods, index, fmt, path):
    collapse, bowtie, sam, bam = mods
    name_to_tid = {n: i for i, n in enumerate(index.names)}
    collapser = collapse.ReadCollapser(index, index.min_fraglength,
                                       index.max_fraglength, 100, False)
    if fmt == "bowtie":
        stream = bowtie.read_bowtie_se(path, name_to_tid, 0)
    else:
        recs = (bam.read_bam_records(path) if fmt == "bam" else
                sam.read_sam_records(path))
        stream = sam.stream_alignments_se(recs, name_to_tid, 0)
    collapser.consume(collapse.group_alignments(stream))
    return collapser.finish()


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("fmt", ["bowtie", "sam", "bam"])
def test_ingest_counts(world, fmt, engine):
    """SampleCounts of SE bowtie, SAM and BAM inputs: the port's ingest
    (its own C++ library, or its Python path) against the original's."""
    path = world["aln"][fmt]
    got = {}
    for label, rsh, native, mods in (
            ("jax", jrsh, jnative, (jcollapse, jbowtie, jsam, jbam)),
            ("torch", trsh, tnative, (tcollapse, tbowtie, tsam, tbam))):
        index = rsh.RshIndex.load(world["rsh"])
        if engine == "native":
            got[label] = native.NativeCollapser(index).collapse_file(
                path, fmt, False, 0, 100, index.min_fraglength,
                index.max_fraglength, nthreads=2)
        else:
            got[label] = _python_counts(mods, index, fmt, path)
    assert got["torch"].total_read_count > 0
    _assert_same(got["jax"], got["torch"])
    if fmt != "bowtie":
        assert jsam.probe_readlength_range_sam_bam(
            jsam.read_sam_records(world["aln"]["sam"])) == \
            tsam.probe_readlength_range_sam_bam(
                tsam.read_sam_records(world["aln"]["sam"]))
    else:
        assert jbowtie.probe_readlength_range(path) == \
            tbowtie.probe_readlength_range(path)


def _graph_inputs(world, mod_rsh):
    index = mod_rsh.RshIndex.load(world["rsh"])
    rng = np.random.default_rng(3)
    adj = np.concatenate([index.single_euma[:, 0],
                          index.multi_euma[:, 0]]).astype(np.float64)
    return index, adj, rng.poisson(adj * 0.5).astype(np.int64)


@pytest.mark.parametrize("euma_cut", [0.0, 3.0])
def test_modules(world, euma_cut):
    """The segment graph and the module decomposition arrays."""
    out = []
    for mod, rsh in ((jmodules, jrsh), (tmodules, trsh)):
        index, adj, rc = _graph_inputs(world, rsh)
        graph = mod.build_segment_graph(index, adj, rc)
        out.append((graph, mod.decompose_modules(graph, euma_cut=euma_cut,
                                                 verbose=0)))
    _assert_same(out[0][0], out[1][0])
    _assert_same(out[0][1], out[1][1])


@pytest.mark.parametrize("writer", ["fpkm", "fraglength", "posbias",
                                    "segments"])
def test_outputs(world, writer):
    """The writers' file bytes."""
    index, adj, rc = _graph_inputs(world, trsh)
    graph = tmodules.build_segment_graph(index, adj, rc)
    mods = tmodules.decompose_modules(graph, verbose=0)
    rng = np.random.default_rng(7)
    ntid = index.n_transcripts
    fpkm_rounds = rng.uniform(0, 50, (3, ntid))
    fpkm_rounds[:, 0] = 0.0
    ieuma = rng.uniform(1, 9, ntid)
    paths = {}
    for label, out, collapse in (("jax", joutputs, jcollapse),
                                 ("torch", toutputs, tcollapse)):
        path = str(world["dir"] / f"{label}.{writer}")
        if writer == "fpkm":
            out.write_fpkm(path, index.names, fpkm_rounds, ieuma, 400,
                           verbose=0)
        elif writer == "fraglength":
            out.write_fraglength_dist(path, index.fraglen_min,
                                      index.n_fraglen,
                                      np.arange(index.fraglen_max + 1) * 3,
                                      np.linspace(0, 1, index.n_fraglen))
        elif writer == "posbias":
            pb = collapse.PosBias(np.array([40, 75, 120]), 100)
            for tid, pos, fl in ((0, 3, 20), (1, 50, 20), (2, 7, 31)):
                pb.add(tid, pos, fl, 0.5)
            out.write_posbias(path, pb)
        else:
            out.write_segments(path, index.names, graph.ct_offsets,
                               graph.ct_tids, mods.cs, adj, rc,
                               fpkm_rounds[1], 400)
        paths[label] = path
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()


def _polish_problem(seed=0):
    rng = np.random.default_rng(seed)
    n_seg, ntid, E = 200, 60, 900
    key = np.unique(rng.integers(0, n_seg, E) * ntid
                    + rng.integers(0, ntid, E))
    cid, tid = (key // ntid).astype(np.int32), (key % ntid).astype(np.int32)
    mult = rng.integers(1, 3, len(key)).astype(np.float64)
    eumaps = rng.uniform(0.1, 2, n_seg)
    denom = np.zeros(ntid)
    np.add.at(denom, tid, mult * eumaps[cid])
    inv = np.where(denom > 0, 1.0 / np.where(denom > 0, denom, 1.0), 0.0)
    return (cid, tid, mult, eumaps, rng.poisson(4, n_seg) * 1.0, inv,
            rng.uniform(0, 10, ntid))


def _collapse_problem():
    """Segments {t0, t1} (100 reads) and {t1} (no reads, EUMAp 1e10), t0
    at its maximum and t1 at 1e-20: each EM step cuts t1 by 1e10, so in a
    polish cycle the read-less segment's intensity falls by more than 1e16
    and its read term is 0 * log1p(-1) = NaN, until t1 underflows to 0."""
    cid = np.array([0, 0, 1], dtype=np.int32)
    tid = np.array([0, 1, 1], dtype=np.int32)
    eumaps = np.array([1.0, 1e10])
    inv = 1.0 / np.array([1.0, 1.0 + 1e10])
    return (cid, tid, np.ones(3), eumaps, np.array([100.0, 0.0]), inv,
            np.array([100.0, 1e-20]))


@pytest.mark.parametrize("fn", ["polish_squarem", "group_rows"])
def test_native_library(fn):
    """The port's own C++ library (built from its csrc/ into its _build/)
    against the JAX package's.  The polish is the JAX library's by default;
    with ``skip_unread`` its gain leaves the read term of segments without
    reads out, which departs from the JAX library only where that term is
    not finite: on ``_polish_problem`` (every term finite) it gives the
    JAX library's bits, and where a read-less segment collapses
    (``_collapse_problem``) the JAX library's stop gain is NaN, on which
    the polish runs on, while the port's stops on a real gain."""
    assert tnative.available()
    assert tnative._SO != jnative._SO
    assert os.path.dirname(tnative._SRCS[0]).endswith(
        os.path.join("emsar_tpu_torch", "csrc"))
    if fn == "polish_squarem":
        *args, theta = _polish_problem()
        tj, tt, ts = theta.copy(), theta.copy(), theta.copy()
        nj = jnative.polish_squarem(*args, tj, 1e-12, 50)
        nt = tnative.polish_squarem(*args, tt, 1e-12, 50)
        assert nj == nt > 0
        _assert_same(tj, tt)
        assert tnative.polish_squarem(*args, ts, 1e-12, 50,
                                      skip_unread=True) == nj
        _assert_same(tj, ts)
        *args, theta = _collapse_problem()
        tj, tt, ts = theta.copy(), theta.copy(), theta.copy()
        nj = jnative.polish_squarem(*args, tj, 1e-9, 50)
        assert tnative.polish_squarem(*args, tt, 1e-9, 50) == nj == 11
        _assert_same(tj, tt)
        assert tj[1] == 0.0  # NaN stop gains ran on until t1 underflowed
        # without t1's read term the first cycle's gain, 1e10 * 1e-20,
        # is real and below epsilon
        assert tnative.polish_squarem(*args, ts, 1e-9, 50,
                                      skip_unread=True) == 1
        assert 0.0 < ts[1] < 1e-40 and ts[0] == tj[0]
    else:
        rng = np.random.default_rng(4)
        h1 = rng.integers(0, 5, 500).astype(np.uint64)
        h2 = rng.integers(0, 3, 500).astype(np.uint64)
        extra = rng.integers(0, 2, 500).astype(np.uint64)
        for e in (None, extra):
            _assert_same(jnative.group_rows(h1, h2, e),
                         tnative.group_rows(h1, h2, e))


def test_timing_and_die(capsys):
    """The port's phase timers fill the port's registry alone; ``die``
    exits 1 with the message on stderr."""
    ttiming.reset_phases()
    jtiming.reset_phases()
    with ttiming.phase("a", verbose=0):
        pass
    with ttiming.phase("a", verbose=0):
        pass
    assert list(ttiming.phase_times()) == ["a"]
    assert jtiming.phase_times() == {}
    ttiming.reset_phases()
    assert ttiming.phase_times() == {}
    with pytest.raises(SystemExit) as e:
        tcommon.die("no such file")
    assert e.value.code == 1
    assert capsys.readouterr().err == "no such file\n"
