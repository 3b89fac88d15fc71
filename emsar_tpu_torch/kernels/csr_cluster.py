"""The CSR SQUAREM cycle on thread-block clusters: hand-written CUDA kernels
and their plain versions.

A stabilized SQUAREM cycle of the CSR solver (``model/solver.py::
_squarem_cycles``) takes theta [R, T] through three EM steps, the step
length, the extrapolation and the accept test.  Below the solver's size
crossover it runs as five launches a cycle:

* ``em_pair(src, plan, ...)``: the cycle's theta, its first two EM steps
  t1 and t2 and the squares r * r and v * v (r = t1 - theta, v = t2 - t1
  - r).  ``src`` is theta [R, T], or the previous cycle's ``(gain, cand,
  t2)``, whose accept ``where(gain >= 0, cand, t2)`` is then this cycle's
  theta, picked by row in the kernel and written out;
* two ``torch.sum`` by row of r * r and v * v, as before;
* ``extrap_gain(theta, t1, t2, r_sq_sum, v_sq_sum, plan, ...)``: cand, the
  EM step from the extrapolation (t2 where it is not positive), and the
  gain terms [R, C] of cand's intensities over t2's;
* ``torch.sum`` by row of the terms: the gain the next cycle accepts on
  (``csr_cycle.cycle_select`` after a block's last cycle).

They replace ``em_iter``, ``gain_of``, ``squarem_cycle`` and the cycle
loop of ``emsar_tpu/model/solver.py::_em_solve``.  A launch runs R x
``plan.n_tiles`` thread-block clusters, a cluster a tile of a row's
modules (``TilePlan``, made once a solve by ``plan_for``), stopping at
hardware cluster barriers between its passes.  The CUDA source is
``csrc/csr_cluster.cu`` (its design, bits and what bounds it are written
there).

The plain versions are the composition the CPU ran before, the ``*_ref``
functions of ``kernels/segment_sum.py`` and ``kernels/csr_cycle.py``
grouped as the kernels group them; the kernels give their bits.  On CPU
tensors the wrappers compute the plain versions (a CPU plan has no
tiles); on CUDA tensors they launch the kernel or raise, never falling
back, and raise too when no cluster of the plan's size fits on the card.
``EM_PAIR_LAUNCHES`` and ``EXTRAP_GAIN_LAUNCHES`` count the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import torch

from . import _build
from .csr_cycle import cycle_extrap_ref, cycle_select_ref, pair_gain_ref
from .segment_sum import EdgeGroups, em_step_cycle_ref, em_step_ref

SOURCE = "csr_cluster.cu"
# the cluster sizes the source is built for (blocks a tile runs on)
CLUSTERS = (1, 2, 4, 8)
# the dynamic shared memory a block may take on the H100 (227 KB): a
# block's share of a tile's edge lists must fit in it
SMEM_BYTES = 232448
EM_PAIR_LAUNCHES = 0
EXTRAP_GAIN_LAUNCHES = 0
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.c_longlong
_INT = ctypes.c_int
# emsar_cluster_em_pair_f32/f64(theta, gain, cand, t2p, cid[5], tid[5],
# reads, inv_denom, theta_out, ratio1, t1, ratio2, t2, rr, vv, R, C, T,
# n_tiles, smem, reads_stride, inv_stride, cluster, stream); a grouping's
# five pointers: TiledGroups.pointers
EM_PAIR_ARGTYPES = [_P] * 4 + [_PP] * 2 + [_P] * 9 + [_LL] * 7 + [
    _INT, _P]
# emsar_cluster_extrap_gain_f32/f64(theta, t1, t2, rsum, vsum, cid[5],
# tid[5], reads, eumaps, inv_denom, ratio, cand, terms, R, C, T, n_tiles,
# smem, reads_stride, inv_stride, cluster, stream)
EXTRAP_GAIN_ARGTYPES = [_P] * 5 + [_PP] * 2 + [_P] * 6 + [_LL] * 7 + [
    _INT, _P]

Source = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class TiledGroups:
    """An ``EdgeGroups`` with its groups in tile order: group i of the
    order is the problem's group ``orig[i]``, with that group's edges in
    their own order (``offsets[i]:offsets[i + 1]`` of ``idx`` and
    ``mult``, ``idx`` the problem's ids); tile t holds the groups
    ``tile_off[t]:tile_off[t + 1]``."""

    offsets: torch.Tensor  # int64 [G + 1]
    idx: torch.Tensor  # int32 [E]
    mult: torch.Tensor  # [E]
    orig: torch.Tensor  # int32 [G]
    tile_off: torch.Tensor  # int32 [n_tiles + 1]

    def pointers(self) -> ctypes.Array:
        """(w, idx, offsets, orig, tile_off) for the kernels."""
        return (ctypes.c_void_p * 5)(
            self.mult.data_ptr(), self.idx.data_ptr(),
            self.offsets.data_ptr(), self.orig.data_ptr(),
            self.tile_off.data_ptr())


@dataclasses.dataclass
class TilePlan:
    """How a problem's rows run on clusters: its modules (the connected
    components of its edges) packed into ``n_tiles`` tiles a row, each
    tile solved by one cluster of ``cluster`` blocks, each block with its
    share of the tile's groups (equal counts) and their edges staged in
    ``smem`` bytes of shared memory.  Every edge of a tile's segments
    leads to the tile's transcripts and back, so a cluster's passes need
    no other cluster's values: the R x n_tiles clusters of a launch never
    wait on each other.  ``by_cid`` and ``by_tid`` are the problem's
    groupings (the plain versions'), ``cid`` and ``tid`` the same in tile
    order (None on the CPU, where only the plain versions run)."""

    by_cid: EdgeGroups
    by_tid: EdgeGroups
    cid: Optional[TiledGroups]
    tid: Optional[TiledGroups]
    n_tiles: int
    cluster: int
    smem: int = 0


def module_labels(by_cid: EdgeGroups, n_tid: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(each segment's module, each transcript's module, each module's
    edges), int64 on the groupings' device, of the problem whose edges
    ``by_cid`` groups by segment: the connected components of its
    segments and transcripts (a segment or transcript without edges is a
    module of its own).  Minimum-label propagation over the edges with
    pointer jumping, on the device: a few rounds of scatters, one host
    read a round."""
    C = by_cid.n_groups
    dev = by_cid.offsets.device
    E = int(by_cid.idx.shape[0])
    deg = torch.diff(by_cid.offsets)
    seg = torch.repeat_interleave(torch.arange(C, device=dev), deg,
                                  output_size=E)
    tid = by_cid.idx.long() + C
    label = torch.arange(C + n_tid, device=dev)
    while True:
        new = label
        for _ in range(2):  # two rounds a host read
            low = torch.minimum(new[seg], new[tid])
            new = new.scatter_reduce(0, seg, low, "amin").scatter_reduce(
                0, tid, low, "amin")
            new = new[new]  # labels are node ids: jump to the label's label
        if torch.equal(new, label):
            break
        label = new
    _, module = torch.unique(label, return_inverse=True)
    n = int(module.max()) + 1 if module.numel() else 0
    edges = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, module[:C], deg)
    return module[:C], module[C:], edges


def _tiles_of(labels, n_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each segment's tile, each transcript's tile): the modules packed
    by weight (edges, and one for each segment and transcript), the
    heaviest first, then in a snake over the tiles, which balances them
    where no module outweighs a tile's share."""
    seg, tid, edges = labels
    n = edges.shape[0]
    weight = (edges + torch.bincount(seg, minlength=n)
              + torch.bincount(tid, minlength=n))
    order = torch.sort(weight, descending=True, stable=True).indices
    pos = torch.arange(n, device=edges.device)
    lap, at = pos // n_tiles, pos % n_tiles
    tile_of = torch.empty_like(pos)
    tile_of[order] = torch.where(lap % 2 == 0, at, n_tiles - 1 - at)
    return tile_of[seg], tile_of[tid]


def _a16(n):
    return (n + 15) // 16 * 16


def _shares(deg: torch.Tensor, tile: torch.Tensor, n_tiles: int,
            cluster: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(groups, edges) of each block's share [n_tiles, cluster] of a
    grouping whose groups of degree ``deg`` sit in tiles ``tile``: tile t's
    groups in tile order split into ``cluster`` shares of equal counts, as
    the kernels split them."""
    counts = torch.bincount(tile, minlength=n_tiles)
    zero = counts.new_zeros(1)
    start = torch.cat([zero, torch.cumsum(counts, 0)])
    order = torch.sort(tile, stable=True).indices
    cum = torch.cat([zero, torch.cumsum(deg[order], 0)])
    q = torch.arange(cluster + 1, device=deg.device)
    bounds = start[:-1, None] + counts[:, None] * q[None, :] // cluster
    return torch.diff(bounds, dim=1), torch.diff(cum[bounds], dim=1)


def _smem(deg_c, tile_c, deg_t, tile_t, n_tiles, cluster, itemsize) -> int:
    """The shared memory a block of a tiling takes, as the kernels lay it
    out: each grouping's staged offsets and ids, edge ids and edge
    weights, then the products of a pass, two per edge of the larger
    share, each 16-byte aligned; the most any block takes (one host
    read)."""
    (n_c, m_c), (n_t, m_t) = (_shares(deg, tile, n_tiles, cluster)
                              for deg, tile in ((deg_c, tile_c),
                                                (deg_t, tile_t)))
    total = _a16(2 * itemsize * torch.maximum(m_c, m_t))
    for n, m in ((n_c, m_c), (n_t, m_t)):
        total = total + _a16(4 * (2 * n + 1)) + _a16(4 * m) + _a16(
            itemsize * m)
    return int(total.max())


def _tiled(g: EdgeGroups, tile: torch.Tensor, n_tiles: int
           ) -> TiledGroups:
    """``g`` with its groups in tile order (a stable sort by ``tile``, the
    tile of each group)."""
    order = torch.sort(tile, stable=True).indices
    deg = torch.diff(g.offsets)[order]
    new_off = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
    E = int(g.idx.shape[0])
    edge = (torch.repeat_interleave(g.offsets[:-1][order] - new_off[:-1],
                                    deg, output_size=E)
            + torch.arange(E, device=deg.device))
    counts = torch.bincount(tile, minlength=n_tiles)
    tile_off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return TiledGroups(offsets=new_off, idx=g.idx[edge].contiguous(),
                       mult=g.mult[edge].contiguous(),
                       orig=order.to(torch.int32),
                       tile_off=tile_off.to(torch.int32))


def tile_plan(by_cid: EdgeGroups, by_tid: EdgeGroups, n_tiles: int,
              cluster: int, tiles=None, smem: Optional[int] = None
              ) -> TilePlan:
    """The problem's modules packed into ``n_tiles`` tiles (``_tiles_of``)
    of ``cluster`` blocks, with the shared memory a block stages.
    ``tiles`` and ``smem``: those of the tiling, when known."""
    tile_c, tile_t = tiles or _tiles_of(
        module_labels(by_cid, by_tid.n_groups), n_tiles)
    if smem is None:
        smem = _smem(torch.diff(by_cid.offsets), tile_c,
                     torch.diff(by_tid.offsets), tile_t, n_tiles, cluster,
                     by_cid.mult.element_size())
    return TilePlan(by_cid=by_cid, by_tid=by_tid,
                    cid=_tiled(by_cid, tile_c, n_tiles),
                    tid=_tiled(by_tid, tile_t, n_tiles), n_tiles=n_tiles,
                    cluster=cluster, smem=smem)


def plan_for(by_cid: EdgeGroups, by_tid: EdgeGroups, rows: int
             ) -> Optional[TilePlan]:
    """The tile plan of ``rows`` rows of a problem, or None when none
    fits.  On the card: the smallest cluster size whose blocks' shares fit
    ``SMEM_BYTES``, with as many tiles a row as the card holds clusters
    at once over ``rows`` (``max_active_clusters``), or as the edges need
    to fit if more, doubled while a share does not fit; a size is passed
    over when the largest module's share alone cannot fit.  (Modules of a
    few hundred edges, as the smoke fixture's, run within 3% of each
    other on every size, PERF.md §6; a larger module needs a larger
    cluster.)  None when even the largest cluster cannot stage the
    largest module.  On the CPU: the plain versions' plan (no tiles)."""
    dev = by_cid.mult.device
    if dev.type != "cuda":
        return TilePlan(by_cid, by_tid, None, None, 1, 1)
    labels = module_labels(by_cid, by_tid.n_groups)
    deg_c, deg_t = torch.diff(by_cid.offsets), torch.diff(by_tid.offsets)
    item = by_cid.mult.element_size()
    # shared memory an edge takes, both groupings' and the products
    per_edge = 2 * (4 + item) + 2 * item
    E = int(by_cid.idx.shape[0])
    n_modules = int(labels[2].shape[0])
    largest = int(labels[2].max()) if n_modules else 0
    for cl in CLUSTERS:
        if largest * per_edge > cl * SMEM_BYTES:
            continue
        fit = min(max_active_clusters(by_cid.mult.dtype, which, cl,
                                      dev.index or 0) for which in (0, 1))
        n_tiles = max(1, fit // rows,
                      math.ceil(E * per_edge / (cl * SMEM_BYTES)))
        while n_tiles <= max(1, n_modules):
            tiles = _tiles_of(labels, n_tiles)
            smem = _smem(deg_c, tiles[0], deg_t, tiles[1], n_tiles, cl,
                         item)
            if smem <= SMEM_BYTES:
                return tile_plan(by_cid, by_tid, n_tiles, cl, tiles, smem)
            n_tiles *= 2
    return None


def em_pair_ref(src: Source, by_cid: EdgeGroups, by_tid: EdgeGroups,
                reads: torch.Tensor, inv_denom: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``em_pair``: (theta, t1, t2, r * r, v * v)."""
    theta = src if isinstance(src, torch.Tensor) else cycle_select_ref(*src)
    t1 = em_step_ref(theta, by_cid, by_tid, reads, inv_denom)
    t2, r_sq, v_sq = em_step_cycle_ref(t1, theta, by_cid, by_tid, reads,
                                       inv_denom)
    return theta, t1, t2, r_sq, v_sq


def extrap_gain_ref(theta: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                    r_sq_sum: torch.Tensor, v_sq_sum: torch.Tensor,
                    by_cid: EdgeGroups, by_tid: EdgeGroups,
                    reads: torch.Tensor, eumaps: torch.Tensor,
                    inv_denom: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``extrap_gain``: (cand, the gain terms)."""
    x = cycle_extrap_ref(theta, t1, t2, r_sq_sum, v_sq_sum)
    cand = em_step_ref(x, by_cid, by_tid, reads, inv_denom)
    return cand, pair_gain_ref(by_cid, reads, eumaps, t2, cand)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name, argtypes in (("emsar_cluster_em_pair", EM_PAIR_ARGTYPES),
                           ("emsar_cluster_extrap_gain",
                            EXTRAP_GAIN_ARGTYPES)):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    lib.emsar_cluster_max_active.restype = ctypes.c_int
    lib.emsar_cluster_max_active.argtypes = [_INT] * 4
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


@functools.lru_cache(maxsize=None)
def max_active_clusters(dtype: torch.dtype, which: int, cluster: int,
                        device_index: int) -> int:
    """Clusters of ``cluster`` blocks of kernel ``which`` (0 em_pair, 1
    extrap_gain) that the card can hold at once
    (``cudaOccupancyMaxActiveClusters``), each block with ``SMEM_BYTES``
    of shared memory.  Raises RuntimeError when the query fails or none
    fits: the cycle cannot run on such clusters."""
    with torch.cuda.device(device_index):
        n = _lib().emsar_cluster_max_active(
            int(dtype == torch.float64), which, cluster, SMEM_BYTES)
    if n <= 0:
        why = f"CUDA error {-n}" if n < 0 else "none fits"
        raise RuntimeError(f"csr_cluster: clusters of {cluster} blocks "
                           f"cannot run on the card ({why})")
    return n


def _stride(a: torch.Tensor, R: int, G: int, name: str, what: str) -> int:
    """0 for one row [G] shared by the R rows, G for a row each [R, G]."""
    if tuple(a.shape) == (G,) and a.is_contiguous():
        return 0
    if tuple(a.shape) == (R, G) and a.is_contiguous():
        return G
    raise ValueError(f"{what}: {name} must be a contiguous [{G}] or "
                     f"[{R}, {G}], got {tuple(a.shape)}")


def _check(like: torch.Tensor, what: str, plan: TilePlan, **tensors) -> None:
    """Raise ValueError unless ``like`` is float32 or float64 on a card and
    every tensor and the plan's tiled groupings are on its device in its
    dtype, the [R, T] tensors contiguous in ``like``'s shape, the
    groupings of one problem (C segments by cid, T transcripts by tid)
    with fewer than 2^31 edges."""
    if like.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {like.device}")
    if like.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: unsupported dtype {like.dtype}")
    if plan.cid is None or plan.tid is None:
        raise ValueError(f"{what}: the plan has no tiles (a CPU plan)")
    R, T = like.shape
    C = plan.by_cid.n_groups
    if (plan.by_tid.n_groups != T or plan.by_cid.n_x != T
            or plan.by_tid.n_x != C):
        raise ValueError(f"{what}: groupings of {C} segments by cid and "
                         f"{plan.by_tid.n_groups} by tid do not fit theta "
                         f"[{R}, {T}]")
    if plan.cid.idx.shape[0] >= 2**31:
        raise ValueError(f"{what}: {plan.cid.idx.shape[0]} edges do not "
                         f"fit int32 offsets")
    if plan.smem > SMEM_BYTES:
        raise ValueError(f"{what}: a block's share takes {plan.smem} bytes "
                         f"of shared memory, more than {SMEM_BYTES}")
    for name, t in dict(tensors, cid_mult=plan.cid.mult,
                        tid_mult=plan.tid.mult).items():
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"want {like.dtype} on {like.device}")
    for name, t in tensors.items():
        if t.dim() == 2 and t.shape[1] == T and (
                t.shape != like.shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{tuple(like.shape)} tensor, got "
                             f"{tuple(t.shape)}")


def _fn(name: str, dtype: torch.dtype):
    return getattr(_lib(), name + ("_f64" if dtype == torch.float64
                                   else "_f32"))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


def _fits(plan: TilePlan, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless a cluster of the plan's size fits on the card."""
    for which in (0, 1):
        max_active_clusters(dtype, which, plan.cluster, device.index or 0)


def em_pair(src: Source, plan: TilePlan, reads: torch.Tensor,
            inv_denom: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(theta, t1, t2, r * r, v * v), all [R, T], of one cycle from
    ``src``: theta [R, T], or the previous cycle's (gain [R], cand, t2),
    accepted by row as ``cycle_select`` does.  reads [C] or [R, C] and
    inv_denom [T] or [R, T] (one row shared, or one each).  One launch on
    the card, R x ``plan.n_tiles`` clusters."""
    global EM_PAIR_LAUNCHES
    like = src if isinstance(src, torch.Tensor) else src[1]
    if like.device.type == "cpu":
        return em_pair_ref(src, plan.by_cid, plan.by_tid, reads, inv_denom)
    what = "cluster_em_pair"
    if isinstance(src, torch.Tensor):
        theta, gain, cand, t2p = src, None, None, None
        named = {"theta": theta}
    else:
        theta = None
        gain, cand, t2p = src
        named = {"gain": gain, "cand": cand, "t2": t2p}
    _check(like, what, plan, reads=reads, inv_denom=inv_denom, **named)
    R, T = like.shape
    C = plan.by_cid.n_groups
    if gain is not None and tuple(gain.shape) != (R,):
        raise ValueError(f"{what}: gain must be [{R}], got "
                         f"{tuple(gain.shape)}")
    rs = _stride(reads, R, C, "reads", what)
    inv_s = _stride(inv_denom, R, T, "inv_denom", what)
    _fits(plan, like.dtype, like.device)
    theta_out = torch.empty_like(like) if theta is None else None
    ratio1, ratio2 = (like.new_empty((R, C)) for _ in range(2))
    t1, t2, r_sq, v_sq = (torch.empty_like(like) for _ in range(4))

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _fn("emsar_cluster_em_pair", like.dtype)(
        ptr(theta), ptr(gain), ptr(cand), ptr(t2p), plan.cid.pointers(),
        plan.tid.pointers(), reads.data_ptr(), inv_denom.data_ptr(),
        ptr(theta_out), ratio1.data_ptr(), t1.data_ptr(), ratio2.data_ptr(),
        t2.data_ptr(), r_sq.data_ptr(), v_sq.data_ptr(), R, C, T,
        plan.n_tiles, plan.smem, rs, inv_s, plan.cluster,
        torch.cuda.current_stream(like.device).cuda_stream)
    _raise_on(rc, what)
    EM_PAIR_LAUNCHES += 1
    return (theta if theta is not None else theta_out), t1, t2, r_sq, v_sq


def extrap_gain(theta: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                r_sq_sum: torch.Tensor, v_sq_sum: torch.Tensor,
                plan: TilePlan, reads: torch.Tensor, eumaps: torch.Tensor,
                inv_denom: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cand [R, T], gain terms [R, C]) of one cycle: cand one EM step from
    the extrapolation of theta, t1, t2 by the row sums [R, 1] of r * r and
    v * v, the terms those of cand's intensities over t2's.  reads and
    eumaps [C] or [R, C], inv_denom [T] or [R, T].  One launch on the
    card, R x ``plan.n_tiles`` clusters."""
    global EXTRAP_GAIN_LAUNCHES
    if theta.device.type == "cpu":
        return extrap_gain_ref(theta, t1, t2, r_sq_sum, v_sq_sum,
                               plan.by_cid, plan.by_tid, reads, eumaps,
                               inv_denom)
    what = "cluster_extrap_gain"
    _check(theta, what, plan, theta=theta, t1=t1, t2=t2, r_sq_sum=r_sq_sum,
           v_sq_sum=v_sq_sum, reads=reads, eumaps=eumaps,
           inv_denom=inv_denom)
    R, T = theta.shape
    C = plan.by_cid.n_groups
    for name, t in (("r_sq_sum", r_sq_sum), ("v_sq_sum", v_sq_sum)):
        if tuple(t.shape) != (R, 1) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"[{R}, 1], got {tuple(t.shape)}")
    rs = _stride(reads, R, C, "reads", what)
    if _stride(eumaps, R, C, "eumaps", what) != rs:
        raise ValueError(f"{what}: eumaps {tuple(eumaps.shape)} and reads "
                         f"{tuple(reads.shape)} differ in shape")
    inv_s = _stride(inv_denom, R, T, "inv_denom", what)
    _fits(plan, theta.dtype, theta.device)
    ratio, terms = (theta.new_empty((R, C)) for _ in range(2))
    cand = torch.empty_like(theta)
    rc = _fn("emsar_cluster_extrap_gain", theta.dtype)(
        theta.data_ptr(), t1.data_ptr(), t2.data_ptr(), r_sq_sum.data_ptr(),
        v_sq_sum.data_ptr(), plan.cid.pointers(), plan.tid.pointers(),
        reads.data_ptr(), eumaps.data_ptr(), inv_denom.data_ptr(),
        ratio.data_ptr(), cand.data_ptr(), terms.data_ptr(), R, C, T,
        plan.n_tiles, plan.smem, rs, inv_s, plan.cluster,
        torch.cuda.current_stream(theta.device).cuda_stream)
    _raise_on(rc, what)
    EXTRAP_GAIN_LAUNCHES += 1
    return cand, terms
