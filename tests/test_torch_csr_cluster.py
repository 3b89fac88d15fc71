"""The CSR cycle on thread-block clusters (``kernels/csr_cluster.py``) on
the CPU, where its wrappers run their plain versions: the five-launch
cycle of ``solver._squarem_cycles`` against ``emsar_tpu``'s
``squarem_cycle`` and ``_em_solve`` (f64, the tolerance of
``tests/test_torch_csr_cycle.py``: rel 1e-9), and bit for bit against the
twelve-launch cycle (R 1, 3 and 16, f32 and f64, the solves to their
stop, NaN stops included); the dispatch on either side of
``CLUSTER_MAX_EDGES``; the wrappers' refusals.  The kernels themselves run
in ``tests/test_torch_cuda_emulated.py`` and, on the card,
``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from emsar_tpu.model import solver as jsolver
from emsar_tpu_torch.kernels import csr_cluster
from emsar_tpu_torch.kernels import segment_sum as ss
from emsar_tpu_torch.model import loop
from emsar_tpu_torch.model import solver as tsolver
from emsar_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_kernels_cuda import _random_problem
from torch_loop_cases import BLOCK_ITERS, EPSILON, Case, bits

CPU = torch.device("cpu")
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
torch.set_num_threads(1)


def _problem(seed, ntid=40):
    """``ntid`` transcripts over 1.5 x as many segments, read-less segments
    and zero denominators among them."""
    return _random_problem(np.random.default_rng(seed), ntid * 3 // 2, ntid,
                           ntid * 11 // 2)


def _jax_solve(problem, th0, block_iters, max_iters, epsilon):
    return jsolver._em_solve(
        problem.edge_cid, problem.edge_tid, problem.edge_mult,
        problem.eumaps, problem.reads, problem.denom, th0,
        n_transcripts=problem.n_transcripts,
        n_segments=len(problem.eumaps), block_iters=block_iters,
        max_iters=max_iters, epsilon=epsilon)


def _assert_bits(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("seed", [1, 2])
def test_cycles_match_jax_squarem_cycle(seed, n):
    """``n`` cycles on clusters from the read-attribution start, against
    JAX's ``squarem_cycle`` run ``n`` times (``_em_solve``'s first block
    of ``n`` cycles, the iteration cap stopping it there): theta within
    rel 1e-9, float64."""
    problem = _problem(seed, 15 + 10 * seed)
    th0 = tsolver.read_attribution_start(problem)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    th = torch.as_tensor(th0)[None]
    got = tsolver._squarem_cycles(p, th, n, tsolver.cycle_plan(
        p, 1, clusters=True))[0].numpy()
    want = np.asarray(_jax_solve(problem, th0, n, 3, 1e-12)[0])
    assert not np.allclose(want, th0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * want.max())


@pytest.mark.parametrize("seed", [3, 4])
def test_em_solve_on_clusters_matches_jax(seed):
    """em_solve through the cluster path: logL within rel 1e-9 of
    ``emsar_tpu``'s ``_em_solve`` from the same start, float64."""
    problem = _problem(seed)
    th0 = tsolver.read_attribution_start(problem)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    assert tsolver.clusters_for(p)
    _, ll, it = tsolver.em_solve(p, torch.as_tensor(th0)[None], 1e-12, 8,
                                 200000, clusters=True)
    _, j_ll, j_it = _jax_solve(problem, th0, 8, 200000, 1e-12)
    assert it > 1 and int(j_it) > 1
    assert abs(float(ll[0]) - float(j_ll)) <= 1e-9 * abs(float(j_ll))


def _sharded(problem, S, dtype):
    rng = np.random.default_rng(S)
    reads = np.where(problem.reads > 0,
                     rng.poisson(problem.reads + 0.5, (S, len(problem.reads))),
                     0.0)
    eumaps = problem.eumaps * rng.uniform(0.8, 1.25, (S, len(problem.reads)))
    denom = np.zeros((S, problem.n_transcripts))
    for s in range(S):
        np.add.at(denom[s], problem.edge_tid,
                  problem.edge_mult * eumaps[s, problem.edge_cid])
    return tmesh.shard_problem(problem, reads, tmesh.make_mesh(device=CPU),
                               dtype=np.float32 if dtype == torch.float32
                               else np.float64, eumaps_per_sample=eumaps,
                               denom_per_sample=denom)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cluster_cycles_are_the_launch_cycles(dtype, R):
    """Ten cycles on clusters give the twelve-launch cycles' bits, also
    cycle by cycle: R 1 and 3 share one row of reads (the CSR solve, its
    restart rounds), R 16 is the batched solve's ShardedProblem with a row
    each."""
    problem = _problem(R + 10)
    if R == 16:
        p = _sharded(problem, R, dtype)
        th = p.theta0
    else:
        p = tsolver.problem_to_device(problem, CPU, dtype)
        rng = np.random.default_rng(R)
        th = torch.as_tensor(np.where(
            problem.denom > 0, rng.uniform(0, 100, (R, problem.n_transcripts)),
            0.0)).to(dtype)
    plan = tsolver.cycle_plan(p, R, clusters=True)
    _assert_bits(tsolver._squarem_cycles(p, th, 10, plan),
                 tsolver._squarem_cycles(p, th, 10, None))
    a = b = th
    for _ in range(3):
        a = tsolver._squarem_cycle(p, a, clusters=True)
        b = tsolver._squarem_cycle(p, b, clusters=False)
        _assert_bits(a, b)
    assert not torch.equal(a, th)


@pytest.mark.parametrize("case", ["stop", "nan", "cap"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_em_solve_paths_agree(dtype, case):
    """em_solve on clusters and on twelve launches a cycle: the same
    theta, logL and blocks, three rows, to a real stop, to a NaN block
    gain (a read-less segment collapsing) and to the cap."""
    c = Case("csr", case)
    p = tsolver.problem_to_device(tsolver.SolverProblem(**c.fields), CPU,
                                  dtype)
    th0 = torch.as_tensor(c.theta0).to(dtype)
    eps = 1e-5 if dtype == torch.float32 else EPSILON
    max_iters = c.cap * BLOCK_ITERS * 3
    got = tsolver.em_solve(p, th0, eps, BLOCK_ITERS, max_iters,
                           clusters=True)
    want = tsolver.em_solve(p, th0, eps, BLOCK_ITERS, max_iters,
                            clusters=False)
    assert got[2] == want[2] >= 1
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_solve_sharded_paths_agree(monkeypatch, dtype):
    """The batched solve of 16 samples (tp 1): theta, logL and blocks the
    same on both paths, every cycle of its first block and of its loop's
    on the path asked for."""
    sp = _sharded(_problem(16), 16, dtype)
    calls = _count_calls(monkeypatch, ("em_pair", "em_step_cycle"))
    got = tmesh.solve_sharded(sp, 1e-9, 64, BLOCK_ITERS, clusters=True)
    cycles = BLOCK_ITERS * (1 + loop.LAST.blocks_run)
    assert calls == {"em_pair": cycles, "em_step_cycle": 0}
    want = tmesh.solve_sharded(sp, 1e-9, 64, BLOCK_ITERS, clusters=False)
    assert calls == {"em_pair": cycles, "em_step_cycle": cycles}
    assert got[2] == want[2] > 0
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])


def _count_calls(monkeypatch, names) -> dict:
    """{name: calls} of ``model/solver.py``'s kernel wrappers ``names``,
    counted from here on."""
    calls = dict.fromkeys(names, 0)

    def counted(name):
        fn = getattr(tsolver, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    for name in names:
        monkeypatch.setattr(tsolver, name, counted(name))
    return calls


@pytest.mark.parametrize("side", ["below", "above"])
def test_dispatch_follows_the_crossover(monkeypatch, side):
    """A problem of E edges takes the cluster kernels when
    ``CLUSTER_MAX_EDGES`` is E (em_pair and extrap_gain once a cycle, the
    twelve launches' kernels never) and the twelve launches when it is E -
    1 (the reverse); both end at the same bits."""
    problem = _problem(7)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    E = p.by_cid.idx.shape[0]
    calls = _count_calls(monkeypatch, ("em_pair", "extrap_gain",
                                       "em_step_cycle", "pair_gain"))
    monkeypatch.setattr(tsolver, "CLUSTER_MAX_EDGES",
                        E if side == "below" else E - 1)
    th0 = torch.as_tensor(tsolver.read_attribution_start(problem))[None]
    th, ll, it = tsolver.em_solve(p, th0, 1e-9, 8, 200000)
    cycles = 8 * loop.LAST.blocks_run
    assert tsolver.clusters_for(p) == (side == "below")
    if side == "below":
        assert calls == {"em_pair": cycles, "extrap_gain": cycles,
                         "em_step_cycle": 0, "pair_gain": 0}
    else:
        assert calls == {"em_pair": 0, "extrap_gain": 0,
                         "em_step_cycle": cycles, "pair_gain": cycles}
    want = tsolver.em_solve(p, th0, 1e-9, 8, 200000,
                            clusters=side != "below")
    assert it == want[2]
    _assert_bits(th, want[0])
    _assert_bits(ll, want[1])


@pytest.mark.parametrize("n_tiles", [1, 3, 7])
def test_tile_plan_packs_whole_modules(n_tiles):
    """A tile plan of a problem of several modules: each grouping's order
    holds every group once, each with its own edges in their own order;
    the tiles' segments and transcripts are closed under the edges (no
    edge leaves its tile, so no cluster needs another's values); the
    tiles hold the modules' edges within one module of an even share."""
    problem = _module_problem(np.random.default_rng(n_tiles))
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    plan = csr_cluster.tile_plan(p.by_cid, p.by_tid, n_tiles, 2)
    assert (plan.n_tiles, plan.cluster) == (n_tiles, 2)
    tile_of = {}
    for name, g, t in (("cid", p.by_cid, plan.cid), ("tid", p.by_tid,
                                                     plan.tid)):
        orig = t.orig.numpy()
        assert np.array_equal(np.sort(orig), np.arange(g.n_groups))
        off, toff = g.offsets.numpy(), t.offsets.numpy()
        for i, gi in enumerate(orig):
            a, b = off[gi], off[gi + 1]
            c, d = toff[i], toff[i + 1]
            assert np.array_equal(t.idx[c:d].numpy(), g.idx[a:b].numpy())
            assert np.array_equal(t.mult[c:d].numpy(), g.mult[a:b].numpy())
        bounds = t.tile_off.numpy()
        assert bounds[0] == 0 and bounds[-1] == g.n_groups
        assert np.all(np.diff(bounds) >= 0)
        tile_of[name] = np.empty(g.n_groups, dtype=np.int64)
        for k in range(n_tiles):
            tile_of[name][orig[bounds[k]:bounds[k + 1]]] = k
    cid = np.repeat(np.arange(p.by_cid.n_groups),
                    np.diff(p.by_cid.offsets.numpy()))
    tid = p.by_cid.idx.numpy()
    assert np.array_equal(tile_of["cid"][cid], tile_of["tid"][tid])
    edges = np.bincount(tile_of["cid"][cid], minlength=n_tiles)
    largest = int(csr_cluster.module_labels(p.by_cid,
                                            p.by_tid.n_groups)[2].max())
    assert edges.max() <= len(cid) / n_tiles + 2 * largest


def _module_problem(rng, n_modules=12):
    """``n_modules`` random modules of 2-9 transcripts side by side, the
    transcripts' ids shuffled (a module's are not contiguous), one
    transcript and one segment without edges."""
    cids, tids, C, T = [], [], 0, 0
    for _ in range(n_modules):
        nt = int(rng.integers(2, 10))
        nc = int(rng.integers(nt, 3 * nt))
        # segment 0 holds every transcript: the module is connected
        key = np.unique(np.concatenate([
            rng.integers(0, nc, 3 * nc) * nt + rng.integers(0, nt, 3 * nc),
            np.arange(nt)]))
        cids.append(key // nt + C)
        tids.append(key % nt + T)
        C, T = C + nc + 1, T + nt
    T += 1
    perm = rng.permutation(T)
    cid = np.concatenate(cids)
    tid = perm[np.concatenate(tids)]
    order = np.lexsort((tid, cid))
    cid, tid = cid[order], tid[order]
    eumaps = rng.uniform(0.1, 2, C)
    mult = rng.integers(1, 3, len(cid)).astype(np.float64)
    denom = np.zeros(T)
    np.add.at(denom, tid, mult * eumaps[cid])
    return tsolver.SolverProblem(
        n_transcripts=T, edge_cid=cid.astype(np.int32),
        edge_tid=tid.astype(np.int32), edge_mult=mult, eumaps=eumaps,
        reads=rng.poisson(3, C) * 1.0, denom=denom)


def test_plan_on_the_cpu_has_no_tiles():
    """On the CPU the plan carries only the problem's groupings (the plain
    versions run), and the cycles on clusters give the twelve launches'
    bits with it."""
    problem = _module_problem(np.random.default_rng(5))
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    plan = tsolver.cycle_plan(p, 2, clusters=True)
    assert plan.cid is None and plan.tid is None
    assert tsolver.cycle_plan(p, 2, clusters=False) is None
    th = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 10, (2, problem.n_transcripts)))
    _assert_bits(tsolver._squarem_cycles(p, th, 4, plan),
                 tsolver._squarem_cycles(p, th, 4, None))


def test_cluster_wrappers_refuse():
    """A tensor neither on the CPU nor on a card is refused, and so a card
    tensor is never computed by a plain version (no fallback)."""
    meta = torch.empty((2, 5), device="meta")
    g = ss.prepare(torch.arange(6), torch.arange(5), torch.ones(5), 5)
    plan = csr_cluster.TilePlan(g, g, None, None, 1, 1)
    with pytest.raises(ValueError, match="device"):
        csr_cluster.em_pair(meta, plan, meta[0], meta[0])
    with pytest.raises(ValueError, match="device"):
        csr_cluster.em_pair((meta[:, 0], meta, meta), plan, meta[0], meta[0])
    with pytest.raises(ValueError, match="device"):
        csr_cluster.extrap_gain(meta, meta, meta, meta[:, :1], meta[:, :1],
                                plan, meta[0], meta[0], meta[0])


def _tiled_plan(n_tiles, cluster, seed=0):
    problem = _module_problem(np.random.default_rng(100 + seed), 14)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    return p, csr_cluster.tile_plan(p.by_cid, p.by_tid, n_tiles, cluster)


CLUSTER_SIZES = [1, 2, 4, 8]


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("n_tiles", [1, 3, 7])
def test_local_endpoints_map_back(n_tiles, cluster):
    """Every edge's tile-local endpoint (rank << RANK_SHIFT | slot) names
    the block of its own tile's cluster whose share of the other grouping
    holds the edge's other end, at that slot: the id there is the edge's
    problem id, in both groupings."""
    _, plan = _tiled_plan(n_tiles, cluster, n_tiles)
    cc = csr_cluster
    desc = plan.blocks.numpy()
    for g, other, s0 in ((plan.cid, plan.tid, cc.T_S0),
                         (plan.tid, plan.cid, cc.C_S0)):
        deg = np.diff(g.offsets.numpy())
        tile = np.repeat(np.repeat(np.arange(n_tiles),
                                   np.diff(g.tile_off.numpy())), deg)
        local = g.local.numpy().astype(np.int64)
        rank, slot = local >> cc.RANK_SHIFT, local & ((1 << cc.RANK_SHIFT)
                                                       - 1)
        assert rank.max(initial=0) < cluster
        block = tile * cluster + rank
        at = desc[block, s0] + slot
        assert np.array_equal(other.orig.numpy()[at], g.idx.numpy())
        # the slot lies within the block's share
        n = desc[block, cc.T_N if s0 == cc.T_S0 else cc.C_N]
        assert np.all(slot < n)
        # some gathers cross blocks: distributed shared memory reads
        own_s0 = desc[:, cc.C_S0 if s0 == cc.T_S0 else cc.T_S0]
        own = np.searchsorted(own_s0, np.arange(len(deg)), "right") - 1
        crossing = np.repeat(own % cluster, deg) != rank
        assert crossing.any() == (cluster > 1)


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("n_tiles", [1, 3, 7])
def test_block_descriptors_are_the_shares(n_tiles, cluster):
    """A block's descriptor holds its shares as ``_shares`` counts them
    (groups, edges; first group and edge their running sums), and its
    image, at its place, holds its groups' ends, its edges' tile-local
    endpoints and weights, laid out at the descriptor's offsets."""
    p, plan = _tiled_plan(n_tiles, cluster, n_tiles)
    cc = csr_cluster
    desc = plan.blocks.numpy()
    assert desc.shape == (n_tiles * cluster, cc.DESC_FIELDS)
    label_c, label_t, _ = cc.module_labels(p.by_cid, p.by_tid.n_groups)
    tile_c, tile_t = cc._tiles_of((label_c, label_t, _), n_tiles)
    image = plan.image.numpy()
    for g, tg, tile, (s0, n, e0, m), (ends, local, w) in (
            (p.by_cid, plan.cid, tile_c, (cc.C_S0, cc.C_N, cc.C_E0, cc.C_M),
             (None, cc.C_LOCAL, cc.C_W)),
            (p.by_tid, plan.tid, tile_t, (cc.T_S0, cc.T_N, cc.T_E0, cc.T_M),
             (cc.T_ENDS, cc.T_LOCAL, cc.T_W))):
        groups, edges = cc._shares(torch.diff(g.offsets), tile, n_tiles,
                                   cluster)
        assert np.array_equal(desc[:, n], groups.reshape(-1).numpy())
        assert np.array_equal(desc[:, m], edges.reshape(-1).numpy())
        assert np.array_equal(desc[:, s0], np.cumsum(desc[:, n]) - desc[:, n])
        assert np.array_equal(desc[:, e0], np.cumsum(desc[:, m]) - desc[:, m])
        off = tg.offsets.numpy()
        for b in range(desc.shape[0]):
            at = 16 * int(desc[b, cc.IMG16])
            a, k = desc[b, s0], desc[b, n]
            q, j = desc[b, e0], desc[b, m]
            part = 0 if ends is None else desc[b, ends]
            got = image[at + part:at + part + 4 * k].view(np.int32)
            assert np.array_equal(got, off[a + 1:a + k + 1] - q)
            got = image[at + desc[b, local]:at + desc[b, local] + 4 * j]
            assert np.array_equal(got.view(np.int32),
                                  tg.local.numpy()[q:q + j])
            got = image[at + desc[b, w]:at + desc[b, w] + 8 * j]
            assert np.array_equal(got.view(np.float64),
                                  tg.mult.numpy()[q:q + j])
    assert np.all(desc[:, cc.IMG_BYTES] % 16 == 0)
    assert 16 * desc[-1, cc.IMG16] + desc[-1, cc.IMG_BYTES] == image.size


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("cluster", [1, 4])
def test_smem_counts_the_vectors(cluster, dtype):
    """A block's shared memory as ``_smem`` counts it and the plan lays it
    out: the mbarrier, the largest image, then for the largest shares the
    cid vectors (orig and three in the dtype) and the tid vectors (orig
    and four), then the products (two per edge of a cid share, one of a
    tid share), each part 16-byte aligned; the layout's offsets are those
    parts' starts."""
    problem = _module_problem(np.random.default_rng(cluster), 10)
    p = tsolver.problem_to_device(problem, CPU, dtype)
    cc = csr_cluster
    item = p.by_cid.mult.element_size()
    plan = cc.tile_plan(p.by_cid, p.by_tid, 3, cluster)
    desc = plan.blocks.numpy()

    def a16(n):
        return -(-int(n) // 16) * 16
    img = max(a16(4 * b[cc.C_N]) + a16(4 * b[cc.C_M]) + a16(item * b[cc.C_M])
              + a16(4 * b[cc.T_N]) + a16(4 * b[cc.T_M])
              + a16(item * b[cc.T_M]) for b in desc)
    cn, tn = desc[:, cc.C_N].max(), desc[:, cc.T_N].max()
    cm, tm = desc[:, cc.C_M].max(), desc[:, cc.T_M].max()
    c_orig = 16 + img
    c_vec = c_orig + a16(4 * cn)
    t_orig = c_vec + 3 * a16(item * cn)
    t_vec = t_orig + a16(4 * tn)
    prod = t_vec + 4 * a16(item * tn)
    want = prod + a16(item * max(2 * cm, tm))
    assert plan.layout == (c_orig, c_vec, a16(item * cn), t_orig, t_vec,
                           a16(item * tn), prod)
    assert plan.smem == want
    label_c, label_t, _ = cc.module_labels(p.by_cid, p.by_tid.n_groups)
    tile_c, tile_t = cc._tiles_of((label_c, label_t, _), 3)
    assert cc._smem(torch.diff(p.by_cid.offsets), tile_c,
                    torch.diff(p.by_tid.offsets), tile_t, 3, cluster,
                    item) == want
    # the vectors are what the edges alone would not count
    assert want - prod >= item * max(2 * cm, tm)
    assert prod - c_vec >= 3 * item * cn + 4 * item * tn


def test_plan_is_made_once_per_edge_structure(monkeypatch):
    """``cycle_plan`` makes one plan per edge structure, rows, dtype and
    device: the same edges in new tensors (a problem built again) take the
    cached plan; other rows, another dtype or other edges make a new one;
    the cache keeps at most ``PLAN_CACHE`` plans, the oldest dropped."""
    monkeypatch.setattr(tsolver, "_PLANS", [])
    monkeypatch.setattr(tsolver, "PLANS_MADE", 0)
    problem = _module_problem(np.random.default_rng(9))
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    again = tsolver.problem_to_device(problem, CPU, torch.float64)
    assert again.by_cid.idx is not p.by_cid.idx
    plan = tsolver.cycle_plan(p, 3)
    assert tsolver.cycle_plan(again, 3) is plan
    assert tsolver.PLANS_MADE == 1
    assert tsolver.cycle_plan(p, 1) is not plan
    f32 = tsolver.problem_to_device(problem, CPU, torch.float32)
    assert tsolver.cycle_plan(f32, 3).by_cid.mult.dtype == torch.float32
    other = tsolver.problem_to_device(_module_problem(
        np.random.default_rng(10)), CPU, torch.float64)
    tsolver.cycle_plan(other, 3)
    assert tsolver.PLANS_MADE == 4
    assert tsolver.cycle_plan(again, 3) is plan  # still cached: 4 plans
    monkeypatch.setattr(tsolver, "PLAN_CACHE", 2)
    tsolver.cycle_plan(p, 2)  # a fifth: the cache keeps the newest two
    assert tsolver.PLANS_MADE == 5 and len(tsolver._PLANS) == 2
    assert tsolver.cycle_plan(p, 1) is not None
    assert tsolver.PLANS_MADE == 6  # rows 1's plan was dropped: remade
    assert tsolver.cycle_plan(p, 3, clusters=False) is None
    assert tsolver.PLANS_MADE == 6


def test_batch_samples_makes_one_restart_plan(monkeypatch, tmp_path):
    """``emsar -M --batch_samples`` over 16 samples on the CPU: the batched
    solve makes one plan (R 16), and the 16 samples' CSR restart loops (R
    3, each from its own ``restart_problem`` arrays) one between them."""
    from emsar_tpu_torch.bench.multisample import split_by_qname
    from emsar_tpu_torch.cli import emsar as torch_cli
    from tests.test_torch_cli import _make_fixture
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tsolver, "_PLANS", [])
    monkeypatch.setattr(tsolver, "PLANS_MADE", 0)
    rows = []
    plan_of = tsolver.cycle_plan

    def counted(p, r, clusters=None):
        rows.append(r)
        return plan_of(p, r, clusters)
    monkeypatch.setattr(tsolver, "cycle_plan", counted)
    rsh, aln = _make_fixture(tmp_path)
    split_by_qname(aln, str(tmp_path), "sample", 16)
    assert torch_cli.main(["-q", "-M", "--batch_samples", "-I", rsh,
                           str(tmp_path / "out"), "s",
                           str(tmp_path / "sample.list")]) == 0
    assert rows.count(16) == 1 and rows.count(3) == 16
    assert tsolver.PLANS_MADE == 2
