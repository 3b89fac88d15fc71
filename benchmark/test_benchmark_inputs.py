"""The generators: the same seed gives the same inputs, the transcriptome
is the port's ``sim.gene_family_transcriptome``, and every listed
alignment is an exact match."""

import numpy as np
import pytest

from benchmark import gen

SHAPES = [(30, 2, 10, 8, 80, 400, 50), (12, 2, 6, 10, 120, 500, 76)]


@pytest.mark.parametrize("shape", SHAPES)
def test_transcriptome_is_the_ports(shape):
    from emsar_tpu_torch.sim import gene_family_transcriptome
    n, a, b, e, lo, hi, _ = shape
    names, seqs, _ = gene_family_transcriptome(np.random.default_rng(5), n,
                                               a, b, e, lo, hi)
    s2, st = gen.gene_family(np.random.default_rng(5), n, a, b, e, lo, hi)
    assert names == st.names and seqs == s2
    assert (st.lengths == [len(s) for s in seqs]).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_reads_deterministic_and_exact(shape, tmp_path):
    n, a, b, e, lo, hi, rl = shape
    seqs, st = gen.gene_family(np.random.default_rng(9), n, a, b, e, lo, hi)
    seed = 2**31 + 77
    w = gen.abundance(len(st.names), 2.0, gen.rng_for(5, 3, 0))
    r1 = gen.sample_reads(st, rl, 4000, w, gen.rng_for(seed, 1, 0))
    r2 = gen.sample_reads(st, rl, 4000, w, gen.rng_for(seed, 1, 0))
    r3 = gen.sample_reads(st, rl, 4000, w, gen.rng_for(seed, 1, 1))
    assert all((getattr(r1, k) == getattr(r2, k)).all()
               for k in ("read", "tid", "pos", "minus"))
    assert len(r1.read) != len(r3.read) or (r1.tid != r3.tid).any()
    assert set(np.unique(r1.read)) == set(range(4000))
    # every alignment is an exact match of the read's sequence
    first = np.concatenate([[True], r1.read[1:] != r1.read[:-1]])
    origin = {int(r): seqs[t][p:p + rl] for r, t, p in
              zip(r1.read[first], r1.tid[first], r1.pos[first])}
    for r, t, p in zip(r1.read, r1.tid, r1.pos):
        assert seqs[t][p:p + rl] == origin[int(r)]
    # and the alignment sets are whole but for rare chance matches
    missed = 0
    for r in list(origin)[:300]:
        s = origin[r]
        true = {(t, i) for t, q in enumerate(seqs) for i in
                range(len(q) - rl + 1) if q.startswith(s, i)}
        mine = {(int(t), int(p)) for t, p in
                zip(r1.tid[r1.read == r], r1.pos[r1.read == r])}
        assert mine <= true
        missed += mine != true
    assert missed <= 6
    # an unstranded library: half the reads on the reverse strand
    assert abs(r1.minus.mean() - 0.5) < 0.05
    assert not gen.sample_reads(st, rl, 400, w, gen.rng_for(seed, 1, 0),
                                0.0).minus.any()


def test_bowtie_lines(tmp_path):
    seqs, st = gen.gene_family(np.random.default_rng(3), 5, 2, 4, 6, 80, 200)
    aln = gen.sample_reads(st, 50, 300, np.ones(len(st.names)),
                           gen.rng_for(1, 1, 0))
    path = str(tmp_path / "a.bowtieout")
    gen.write_bowtie(path, aln, st.names, 50)
    lines = open(path).read().splitlines()
    assert len(lines) == len(aln.read)
    for line, r, t, p in zip(lines, aln.read, aln.tid, aln.pos):
        f = line.split("\t")
        assert (int(f[0][1:]), f[1], f[2], int(f[3]), len(f[4])) == \
            (r, "-" if aln.minus[r] else "+", st.names[t], p, 50)
    assert {line.split("\t")[1] for line in lines} == {"+", "-"}
