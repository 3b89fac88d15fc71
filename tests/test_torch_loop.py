"""The port's convergence loops (``emsar_tpu_torch/model/loop.py``) on the
CPU: the four solvers' loops (CSR ``em_solve`` over rows, the dense
torch.bmm ``_solve_loop`` for one round and for restart rounds, the
kernel path ``_dense_solve_pallas``, the sharded ``solve_sharded`` in a
world of one) give the same bits (theta, logL, blocks) for any
``CHECK_EVERY``, and the bits of the parent's loops (copied below as they
were: one host read of the stop flag per block), and agree with the JAX
package's ``lax.while_loop``s on the same NumPy inputs with the same block
count.  Three stops: convergence between two reads of the flag, a NaN
block gain (``emsar_tpu``'s behaviour, kept), and the block cap.

Tolerances against JAX (float64): logL rel 1e-10 and intensities rtol
1e-7 (``tests/test_torch_dense.py``), restart rounds intensities rtol
1e-6, the sharded solve logL rel 1e-9 and theta rtol / atol 1e-8
(``tests/test_torch_mesh.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from emsar_tpu.model import dense as jdense
from emsar_tpu.model import solver as jsolver
from emsar_tpu.parallel import mesh as jmesh
from emsar_tpu_torch.model import loop
from torch_loop_cases import (B, BLOCK_ITERS, C, CAP_BLOCKS, CASES,
                              EPSILON, LOOPS, T, Case, same_bits)

torch.set_num_threads(1)


def _jax(c):
    """(theta, logL or None, blocks) of the JAX package's loop."""
    bi, cap = BLOCK_ITERS, c.cap
    batch = c.batch
    if c.name == "csr":
        f = c.fields
        ntid, nseg = f["n_transcripts"], len(f["reads"])
        args = [jnp.asarray(f[k]) for k in ("edge_cid", "edge_tid",
                                            "edge_mult", "eumaps", "reads",
                                            "denom")]
        th, ll, it = jax.vmap(lambda th0: jsolver._em_solve(
            *args, th0, n_transcripts=ntid, n_segments=nseg,
            block_iters=bi, max_iters=cap * bi * 3,
            epsilon=jnp.asarray(EPSILON)))(jnp.asarray(c.theta0))
        return np.asarray(th), np.asarray(ll), int(np.max(it))
    if c.name == "dense":
        th, it = jdense.solve_dense_batch(batch, EPSILON, bi, cap)
        return th[None], None, it
    if c.name == "restarts":
        th, it = jdense._dense_restart_jax(
            jnp.asarray(batch.flat_idx), jnp.asarray(batch.eumaps),
            jnp.asarray(batch.reads), jnp.asarray(c.theta0),
            jnp.asarray(EPSILON), B, C, T, bi, cap)
        return np.asarray(th), None, int(it)
    if c.name == "kernel":
        th, it = jdense.solve_dense_batch(batch, EPSILON, bi, cap,
                                          use_pallas=True)
        return th, None, it
    sp = jmesh.shard_problem(jsolver.SolverProblem(**c.fields), c.reads,
                             jmesh.make_mesh(1), dtype=np.float64)
    th, ll, it = jmesh.solve_sharded(sp, EPSILON, cap, bi)
    return th, ll, it


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", LOOPS)
def test_any_check_every_gives_the_parents_bits(monkeypatch, name, case):
    """CHECK_EVERY 1, 5 and 16 and the plain loop give the parent loop's
    theta, logL and block count bit for bit, the stop landing between two
    reads of the flag (blocks ran after it, as masked no-ops)."""
    c = Case(name, case)
    parent = c.port(parent=True)
    n, gain = parent[2], parent[3]
    if case == "nan":
        assert bool(torch.isnan(gain).any()), gain
    elif case == "cap":
        assert n == CAP_BLOCKS and bool((gain >= EPSILON).any()), gain
    else:
        assert n > CAP_BLOCKS and not bool(torch.isnan(gain).any()), gain
    assert (n - 1) % 5 and (n - 1) % 16  # a stop between two reads
    same_bits(c.port(plain=True), parent)
    assert loop.LAST.reads == loop.LAST.blocks_run == n
    for k in (1, 5, 16):
        monkeypatch.setattr(loop, "CHECK_EVERY", k)
        same_bits(c.port(), parent)
        assert loop.LAST.blocks_run == 1 + k * -(-(n - 1) // k)


def _intensities_of(c, theta):
    """Segment intensities (E * M theta) of each row of ``theta``, as the
    CSR problem's [rows, segments]."""
    f = c.fields
    th = np.asarray(theta, dtype=np.float64).reshape(-1, f["n_transcripts"])
    s = np.zeros((th.shape[0], len(f["reads"])))
    for r in range(th.shape[0]):
        np.add.at(s[r], f["edge_cid"], f["edge_mult"] * th[r, f["edge_tid"]])
    return f["eumaps"] * s


def _loglik_of(c, theta, reads):
    lam = _intensities_of(c, theta)
    pos = lam > 0
    return np.sum(np.where(pos, reads * np.log(np.where(pos, lam, 1.0))
                           - lam, 0.0), axis=1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", LOOPS)
def test_loop_matches_jax(name, case):
    """The same block count as the JAX package's while_loop on the same
    inputs, and its solution: logL rel 1e-10, intensities rtol 1e-7
    (restart rounds 1e-6; the sharded solve logL rel 1e-9, theta rtol /
    atol 1e-8)."""
    c = Case(name, case)
    th, ll, it, _ = c.port()
    j_th, j_ll, j_it = _jax(c)
    assert it == j_it
    th = th.numpy() if isinstance(th, torch.Tensor) else th
    if name == "sharded":
        assert abs(ll - j_ll) <= 1e-9 * abs(j_ll), (ll, j_ll)
        np.testing.assert_allclose(th, j_th, rtol=1e-8, atol=1e-8)
        return
    reads = c.fields["reads"]
    ll_g, ll_w = _loglik_of(c, th, reads), _loglik_of(c, j_th, reads)
    np.testing.assert_allclose(ll_g, ll_w, rtol=1e-10, atol=0)
    if ll is not None:
        np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll), rtol=1e-10)
    np.testing.assert_allclose(_intensities_of(c, th),
                               _intensities_of(c, j_th),
                               rtol=1e-6 if name == "restarts" else 1e-7,
                               atol=1e-12)


class _FakeGraph:
    """A stand-in for ``loop._CudaGraph`` on the CPU: capture runs the
    block in a mode where it only counts launches (as a wrapper does when
    recorded), replay applies the recorded block's effect without Python
    (no counter ticks), as a real replay does."""

    def __init__(self, state):
        self.state = state

    def warm_up(self, block):
        block()

    def capture(self, block):
        self.state["capturing"] = True
        block()
        self.state["capturing"] = False

    def replay(self):
        self.state["apply"]()


@pytest.mark.parametrize("k", [1, 5, 16])
def test_counters_count_replays(monkeypatch, k):
    """The launch counters after a replayed solve equal the eager solve's:
    the capture's ticks are taken back and added once per replay."""
    monkeypatch.setattr(loop, "CHECK_EVERY", k)
    per_block = (3, 4, 1)  # sum_groups, em_step, squarem_block launches

    def solve(graph):
        for mod, attr in loop.COUNTERS:
            monkeypatch.setattr(mod, attr, 0)
        state = {"capturing": False}
        active = torch.ones(2, dtype=torch.bool)
        it = torch.zeros((), dtype=torch.int64)
        left = torch.tensor([3, 9])  # blocks until each row stops

        def apply():
            loop.advance(active, it, ())
            left.sub_(active.long())
            active.logical_and_(left > 0)

        def block():
            for (mod, attr), n in zip(loop.COUNTERS, per_block):
                setattr(mod, attr, getattr(mod, attr) + n)
            if not state["capturing"]:
                apply()

        state["apply"] = apply
        if graph:
            stats = loop._run_graph(block, active, k, _FakeGraph(state))
        else:
            stats = loop._run_eager(block, active, k)
        return ([getattr(m, a) for m, a in loop.COUNTERS], int(it),
                stats.blocks_run)

    eager, replayed = solve(False), solve(True)
    assert eager == replayed
    counts, it, blocks = replayed
    assert it == 9 and blocks == 1 + k * -(-8 // k)
    assert counts == [n * blocks for n in per_block]


def test_advance_masks_rows_and_counts_blocks():
    """``advance``: a stopped row keeps its state, a 0-d flag masks all;
    the counter grows only while something is active."""
    active = torch.tensor([True, False])
    it = torch.zeros((), dtype=torch.int64)
    state, new = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    loop.advance(active, it, ((state, new),))
    assert state[0].eq(1).all() and state[1].eq(0).all() and int(it) == 1
    flag = torch.tensor(False)
    loop.advance(flag, it, ((state, 2 * new),))
    assert state[0].eq(1).all() and int(it) == 1
