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
  (``csr_cycle.block_end`` after a block's last cycle, which picks the
  accepted row's intensities from those ``extrap_gain`` summed in that
  cycle, ``intensities=True``).

They replace ``em_iter``, ``gain_of``, ``squarem_cycle`` and the cycle
loop of ``emsar_tpu/model/solver.py::_em_solve``.  A launch runs
ceil(R / ``plan.rows``) x ``plan.n_tiles`` thread-block clusters, a
cluster a tile of a row's modules, stopping at hardware cluster barriers
between its passes.  The CUDA source is ``csrc/csr_cluster.cu`` (its
design, bits and what bounds it are written there): each block's share
of the edges comes into its shared memory by one bulk copy of the
Tensor Memory Accelerator, and every value a pass reads is in the
shared memory of a block of the cluster.

The plan (``TilePlan``, made by ``plan_for`` on the card; once per edge
structure, rows, dtype and device through ``model/solver.py::
cycle_plan``'s cache) holds the modules packed into tiles, both edge
groupings in tile order with each edge's other end as a tile-local
endpoint (the rank of the cluster's block whose share holds it, and its
slot there), a descriptor of each block's shares, and each block's image
of its shares as its shared memory lays them out.  A block keeps per
edge its endpoint and weight in both groupings and two products, per
segment its end, id and three vectors, per transcript its end, id and
four vectors (``module_bytes``): in float64 an 8-block cluster stages a
module of at most ~34,800 edges shaped as the cluster sweep's (and the
smoke fixture's) are (``bench/cluster_sweep.py::largest_module``;
~58,000 in float32); a larger one sends the problem to the launch path
(``model/solver.py::_squarem_cycle_launches``).  With the groupings it
was made for, a plan holds 2 x (16 + 3 x item) bytes an edge (80 in float64) and
24 a segment or transcript, and the images' alignment (``nbytes``).

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
# block's share of a tile, its image, vectors and products, must fit in it
SMEM_BYTES = 232448
# a tile-local endpoint: the rank of the cluster's block that holds the
# other end << RANK_SHIFT | its slot in that block's share
RANK_SHIFT = 28
# the block descriptors' fields (``TilePlan.blocks``, csr_cluster.cu's
# BlockDesc): each grouping's share (first group in tile order, groups,
# first edge, edges), the image (at 16 x IMG16 bytes, IMG_BYTES long) and
# its parts' offsets from its start (the cid group ends at 0)
(C_S0, C_N, C_E0, C_M, T_S0, T_N, T_E0, T_M, IMG16, IMG_BYTES, C_LOCAL, C_W,
 T_ENDS, T_LOCAL, T_W) = range(15)
DESC_FIELDS = 16
# where a block's image starts in its shared memory (after the mbarrier),
# and the vectors a block keeps of each cid and each tid of its shares
IMAGE_AT = 16
C_VECTORS, T_VECTORS = 3, 4
# a plan of R > 1 rows gives each cluster all R rows of its tile (staged
# once, the rows one after another) from this many edges a row on, else a
# row each: bench/cluster_sweep.py's row_layouts found the former faster
# at R 3 and R 16 from 360,000 edges on, the latter up to 90,000 (even at
# 180,000 at R 3; PERF.md §6)
ALL_ROWS_MIN_EDGES = 360_000
EM_PAIR_LAUNCHES = 0
EXTRAP_GAIN_LAUNCHES = 0
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
_INT = ctypes.c_int
# emsar_cluster_em_pair_f32/f64(theta, gain, cand, t2p, tiles[4],
# layout[7], reads, inv_denom, theta_out, t1, t2, rr, vv, R, T, n_tiles,
# rows, smem, reads_stride, inv_stride, cluster, stream): TilePlan.args
EM_PAIR_ARGTYPES = [_P] * 4 + [_PP, _PI] + [_P] * 7 + [_LL] * 7 + [
    _INT, _P]
# emsar_cluster_extrap_gain_f32/f64(theta, t1, t2, rsum, vsum, tiles[4],
# layout[7], reads, eumaps, inv_denom, cand, terms, s_t2, s_cand, R, C, T,
# n_tiles, rows, smem, reads_stride, inv_stride, cluster, stream)
EXTRAP_GAIN_ARGTYPES = [_P] * 5 + [_PP, _PI] + [_P] * 7 + [_LL] * 8 + [
    _INT, _P]

Source = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class TiledGroups:
    """An ``EdgeGroups`` with its groups in tile order: group i of the
    order is the problem's group ``orig[i]``, with that group's edges in
    their own order (``offsets[i]:offsets[i + 1]`` of ``idx`` and
    ``mult``, ``idx`` the problem's ids); tile t holds the groups
    ``tile_off[t]:tile_off[t + 1]``.  ``local``: each edge's other end in
    its tile, the rank of the cluster's block whose share of the other
    grouping holds it << ``RANK_SHIFT`` | its slot there."""

    offsets: torch.Tensor  # int64 [G + 1]
    idx: torch.Tensor  # int32 [E]
    mult: torch.Tensor  # [E]
    orig: torch.Tensor  # int32 [G]
    tile_off: torch.Tensor  # int32 [n_tiles + 1]
    local: Optional[torch.Tensor] = None  # int32 [E]


@dataclasses.dataclass
class TilePlan:
    """How a problem's rows run on clusters: its modules (the connected
    components of its edges) packed into ``n_tiles`` tiles a row, each
    tile solved by one cluster of ``cluster`` blocks, each block with its
    share of the tile's groups (equal counts).  Every edge of a tile's
    segments leads to the tile's transcripts and back, so a cluster's
    passes need no other cluster's values: the clusters of a launch never
    wait on each other.  A cluster takes ``rows`` rows of a tile one after
    another (a launch: ceil(R / rows) x n_tiles clusters).  ``by_cid`` and
    ``by_tid`` are the problem's groupings (the plain versions'), ``cid``
    and ``tid`` the same in tile order (None on the CPU, where only the
    plain versions run).  ``blocks`` [n_tiles x cluster, DESC_FIELDS]
    int32 describes each block (block tile * cluster + rank), ``image``
    holds every block's image (its shares' group ends, tile-local
    endpoints and weights, laid out as in its shared memory), ``layout``
    the seven offsets of the vectors and products in every block's shared
    memory, and a block takes ``smem`` bytes of it."""

    by_cid: EdgeGroups
    by_tid: EdgeGroups
    cid: Optional[TiledGroups]
    tid: Optional[TiledGroups]
    n_tiles: int
    cluster: int
    smem: int = 0
    blocks: Optional[torch.Tensor] = None
    image: Optional[torch.Tensor] = None
    layout: Tuple[int, ...] = ()
    rows: int = 1
    _args: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    def args(self) -> tuple:
        """(the four pointers of csr_cluster.cu's Tiles, the layout), as
        the kernels take them; made once."""
        if self._args is None:
            self._args = (
                (ctypes.c_void_p * 4)(self.blocks.data_ptr(),
                                      self.image.data_ptr(),
                                      self.cid.orig.data_ptr(),
                                      self.tid.orig.data_ptr()),
                (ctypes.c_int * 7)(*self.layout))
        return self._args

    def nbytes(self) -> int:
        """Bytes of the tensors the plan holds, its groupings' included."""
        tensors = {id(t): t for g in (self.by_cid, self.by_tid)
                   for t in (g.offsets, g.idx, g.mult)}
        for g in (self.cid, self.tid):
            if g is not None:
                tensors.update((id(t), t) for t in (
                    getattr(g, f.name) for f in dataclasses.fields(g))
                    if t is not None)
        for t in (self.blocks, self.image):
            if t is not None:
                tensors[id(t)] = t
        return sum(t.numel() * t.element_size() for t in tensors.values())


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
    the plan's blocks take them."""
    counts = torch.bincount(tile, minlength=n_tiles)
    zero = counts.new_zeros(1)
    start = torch.cat([zero, torch.cumsum(counts, 0)])
    order = torch.sort(tile, stable=True).indices
    cum = torch.cat([zero, torch.cumsum(deg[order], 0)])
    q = torch.arange(cluster + 1, device=deg.device)
    bounds = start[:-1, None] + counts[:, None] * q[None, :] // cluster
    return torch.diff(bounds, dim=1), torch.diff(cum[bounds], dim=1)


def _image_parts(n_c, m_c, n_t, m_t, item: int) -> tuple:
    """Each block's image parts' offsets from its start, and its bytes, as
    csr_cluster.cu reads them: (c_local, c_w, t_ends, t_local, t_w,
    bytes); the cid group ends at 0; each part 16-byte aligned."""
    c_local = _a16(4 * n_c)
    c_w = c_local + _a16(4 * m_c)
    t_ends = c_w + _a16(item * m_c)
    t_local = t_ends + _a16(4 * n_t)
    t_w = t_local + _a16(4 * m_t)
    return c_local, c_w, t_ends, t_local, t_w, t_w + _a16(item * m_t)


def _layout(n_c, m_c, n_t, m_t, item: int) -> Tuple[Tuple[int, ...], int]:
    """(the seven offsets of csr_cluster.cu's Layout, the shared memory a
    block takes) for blocks of shares (n_c, m_c) and (n_t, m_t) (flat
    tensors, a block each): the mbarrier, the largest image, then the
    same offsets in every block for the cid vectors (orig and
    ``C_VECTORS`` in the dtype, for the largest cid share), the tid
    vectors (orig and ``T_VECTORS``) and the products (two per edge of a
    cid share, one of a tid share), each 16-byte aligned (one host
    read)."""
    img = _image_parts(n_c, m_c, n_t, m_t, item)[-1]
    img, cn, tn, cm, tm = (int(v) for v in torch.stack(
        [a.max() for a in (img, n_c, n_t, m_c, m_t)]).tolist())
    c_orig = IMAGE_AT + img
    c_vec = c_orig + _a16(4 * cn)
    c_stride = _a16(item * cn)
    t_orig = c_vec + C_VECTORS * c_stride
    t_vec = t_orig + _a16(4 * tn)
    t_stride = _a16(item * tn)
    prod = t_vec + T_VECTORS * t_stride
    return ((c_orig, c_vec, c_stride, t_orig, t_vec, t_stride, prod),
            prod + _a16(item * max(2 * cm, tm)))


def _smem(deg_c, tile_c, deg_t, tile_t, n_tiles, cluster, itemsize) -> int:
    """The shared memory a block of a tiling takes, as the kernels lay it
    out (``_layout``): the most any block's image takes, then the vectors
    of the largest shares and their products (one host read)."""
    (n_c, m_c), (n_t, m_t) = (_shares(deg, tile, n_tiles, cluster)
                              for deg, tile in ((deg_c, tile_c),
                                                (deg_t, tile_t)))
    return _layout(n_c.reshape(-1), m_c.reshape(-1), n_t.reshape(-1),
                   m_t.reshape(-1), itemsize)[1]


def module_bytes(edges, segments, transcripts, itemsize: int):
    """About the shared memory the shares of a module take in all (a
    block's is its share of it): per edge its endpoint and weight in both
    groupings and two products; per segment its end, orig and
    ``C_VECTORS`` vectors; per transcript its end, orig and
    ``T_VECTORS``.  Alignment left out."""
    return (edges * (2 * (4 + itemsize) + 2 * itemsize)
            + segments * (8 + C_VECTORS * itemsize)
            + transcripts * (8 + T_VECTORS * itemsize))


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


@dataclasses.dataclass
class _Place:
    """The blocks' shares of a grouping in tile order: each block's first
    group ``s0``, groups ``n``, first edge ``e0`` and edges ``m`` [B],
    each group's block and slot [G], each edge's block and slot [E]."""

    s0: torch.Tensor
    n: torch.Tensor
    e0: torch.Tensor
    m: torch.Tensor
    block: torch.Tensor
    slot: torch.Tensor
    edge_block: torch.Tensor
    edge_slot: torch.Tensor


def _place(g: TiledGroups, n_tiles: int, cluster: int) -> _Place:
    """Each tile's groups split into ``cluster`` shares of equal counts
    (``_shares``), a block each."""
    dev = g.offsets.device
    toff = g.tile_off.long()
    q = torch.arange(cluster + 1, device=dev)
    bounds = toff[:-1, None] + torch.diff(toff)[:, None] * q // cluster
    s0 = bounds[:, :-1].reshape(-1).contiguous()
    n = torch.diff(bounds, dim=1).reshape(-1)
    G, E = g.orig.shape[0], g.idx.shape[0]
    pos = torch.arange(G, device=dev)
    # an empty share starts where the next one does: the last block that
    # starts at or before a group holds it
    block = torch.searchsorted(s0, pos, right=True) - 1
    e0 = g.offsets[s0]
    edge_block = torch.repeat_interleave(block, torch.diff(g.offsets),
                                         output_size=E)
    return _Place(s0=s0, n=n, e0=e0, m=g.offsets[s0 + n] - e0, block=block,
                  slot=pos - s0[block], edge_block=edge_block,
                  edge_slot=torch.arange(E, device=dev) - e0[edge_block])


def _local(g: TiledGroups, other: TiledGroups, where: _Place,
           cluster: int) -> torch.Tensor:
    """The tile-local endpoint (rank << RANK_SHIFT | slot) of each edge of
    ``g``: where its other end lies in ``other``'s shares."""
    at = torch.empty(other.orig.shape[0], dtype=torch.int64,
                     device=other.orig.device)
    at[other.orig.long()] = torch.arange(other.orig.shape[0],
                                         device=at.device)
    pos = at[g.idx.long()]
    return (((where.block[pos] % cluster) << RANK_SHIFT)
            | where.slot[pos]).to(torch.int32)


def _blocks(cid: TiledGroups, tid: TiledGroups, n_tiles: int, cluster: int,
            item: int):
    """(the block descriptors, the images, the layout, the shared memory a
    block takes) of a tiling; sets each grouping's ``local``."""
    pc, pt = (_place(g, n_tiles, cluster) for g in (cid, tid))
    cid.local = _local(cid, tid, pt, cluster)
    tid.local = _local(tid, cid, pc, cluster)
    parts = _image_parts(pc.n, pc.m, pt.n, pt.m, item)
    size = parts[-1]
    base = torch.cumsum(size, 0) - size
    image = torch.zeros(int(size.sum()), dtype=torch.uint8,
                        device=size.device)
    words, values = image.view(torch.int32), image.view(cid.mult.dtype)

    def put(view, part, block, slot, x):
        view[(base + part)[block] // view.element_size() + slot] = x
    zero = torch.zeros_like(size)
    c_local, c_w, t_ends, t_local, t_w, _ = parts
    for g, p, ends, local, w in ((cid, pc, zero, c_local, c_w),
                                 (tid, pt, t_ends, t_local, t_w)):
        put(words, ends, p.block, p.slot,
            (g.offsets[1:] - p.e0[p.block]).to(torch.int32))
        put(words, local, p.edge_block, p.edge_slot, g.local)
        put(values, w, p.edge_block, p.edge_slot, g.mult)
    blocks = torch.stack([pc.s0, pc.n, pc.e0, pc.m, pt.s0, pt.n, pt.e0,
                          pt.m, base // 16, size, c_local, c_w, t_ends,
                          t_local, t_w, zero], 1).to(torch.int32)
    layout, smem = _layout(pc.n, pc.m, pt.n, pt.m, item)
    return blocks.contiguous(), image, layout, smem


def tile_plan(by_cid: EdgeGroups, by_tid: EdgeGroups, n_tiles: int,
              cluster: int, tiles=None, rows: int = 1) -> TilePlan:
    """The problem's modules packed into ``n_tiles`` tiles (``_tiles_of``)
    of ``cluster`` blocks, each cluster taking ``rows`` rows, with the
    blocks' descriptors, images and shared memory.  ``tiles``: those of
    the tiling, when known."""
    tile_c, tile_t = tiles or _tiles_of(
        module_labels(by_cid, by_tid.n_groups), n_tiles)
    cid = _tiled(by_cid, tile_c, n_tiles)
    tid = _tiled(by_tid, tile_t, n_tiles)
    blocks, image, layout, smem = _blocks(cid, tid, n_tiles, cluster,
                                          by_cid.mult.element_size())
    return TilePlan(by_cid=by_cid, by_tid=by_tid, cid=cid, tid=tid,
                    n_tiles=n_tiles, cluster=cluster, smem=smem,
                    blocks=blocks, image=image, layout=layout, rows=rows)


def plan_for(by_cid: EdgeGroups, by_tid: EdgeGroups, rows: int,
             rows_a_cluster: Optional[int] = None) -> Optional[TilePlan]:
    """The tile plan of ``rows`` rows of a problem, each cluster taking
    ``rows_a_cluster`` of them (by default all from
    ``ALL_ROWS_MIN_EDGES`` edges a row on, else one), or None when none
    fits.  On the card: the
    smallest cluster size whose blocks' shares fit ``SMEM_BYTES``, with as
    many tiles a row as the card holds clusters at once over the launch's
    ceil(rows / rows_a_cluster) (``max_active_clusters``), or as the
    shares need to fit if more, doubled while a share does not fit; a size
    is passed over when the largest module's share alone cannot fit
    (``module_bytes``).  (Modules of a few hundred edges, as the smoke
    fixture's, run within 3% of each other on every size, PERF.md §6; a
    larger module needs a larger cluster.)  None when even the largest
    cluster cannot stage the largest module.  On the CPU: the plain
    versions' plan (no tiles)."""
    dev = by_cid.mult.device
    if dev.type != "cuda":
        return TilePlan(by_cid, by_tid, None, None, 1, 1)
    if rows_a_cluster is None:
        rows_a_cluster = (rows if by_cid.idx.shape[0] >= ALL_ROWS_MIN_EDGES
                          else 1)
    labels = module_labels(by_cid, by_tid.n_groups)
    deg_c, deg_t = torch.diff(by_cid.offsets), torch.diff(by_tid.offsets)
    item = by_cid.mult.element_size()
    seg, tid, edges = labels
    n_modules = int(edges.shape[0])
    weight = module_bytes(edges, torch.bincount(seg, minlength=n_modules),
                          torch.bincount(tid, minlength=n_modules), item)
    largest, total = ((int(v) for v in torch.stack(
        [weight.max(), weight.sum()]).tolist()) if n_modules else (0, 0))
    for cl in CLUSTERS:
        if largest > cl * SMEM_BYTES:
            continue
        fit = min(max_active_clusters(by_cid.mult.dtype, which, cl,
                                      dev.index or 0) for which in (0, 1))
        groups = -(-rows // rows_a_cluster)
        n_tiles = max(1, fit // groups,
                      math.ceil(total / (cl * SMEM_BYTES)))
        while n_tiles <= max(1, n_modules):
            tiles = _tiles_of(labels, n_tiles)
            if _smem(deg_c, tiles[0], deg_t, tiles[1], n_tiles, cl,
                     item) <= SMEM_BYTES:
                return tile_plan(by_cid, by_tid, n_tiles, cl, tiles,
                                 rows_a_cluster)
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
                    inv_denom: torch.Tensor, *, intensities: bool = False
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``extrap_gain``: (cand, the gain terms), and with
    ``intensities`` t2's and cand's intensities too."""
    x = cycle_extrap_ref(theta, t1, t2, r_sq_sum, v_sq_sum)
    cand = em_step_ref(x, by_cid, by_tid, reads, inv_denom)
    gain = pair_gain_ref(by_cid, reads, eumaps, t2, cand,
                         intensities=intensities)
    return (cand, *gain) if intensities else (cand, gain)


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
    if plan.cid is None or plan.tid is None or plan.blocks is None:
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
    if plan.image.device != like.device:
        raise ValueError(f"{what}: the plan is on {plan.image.device}, "
                         f"want {like.device}")
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
    the card, ceil(R / ``plan.rows``) x ``plan.n_tiles`` clusters."""
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
    t1, t2, r_sq, v_sq = (torch.empty_like(like) for _ in range(4))

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _fn("emsar_cluster_em_pair", like.dtype)(
        ptr(theta), ptr(gain), ptr(cand), ptr(t2p), *plan.args(),
        reads.data_ptr(), inv_denom.data_ptr(), ptr(theta_out),
        t1.data_ptr(), t2.data_ptr(), r_sq.data_ptr(), v_sq.data_ptr(), R,
        T, plan.n_tiles, plan.rows, plan.smem, rs, inv_s, plan.cluster,
        torch.cuda.current_stream(like.device).cuda_stream)
    _raise_on(rc, what)
    EM_PAIR_LAUNCHES += 1
    return (theta if theta is not None else theta_out), t1, t2, r_sq, v_sq


def extrap_gain(theta: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                r_sq_sum: torch.Tensor, v_sq_sum: torch.Tensor,
                plan: TilePlan, reads: torch.Tensor, eumaps: torch.Tensor,
                inv_denom: torch.Tensor, *, intensities: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """(cand [R, T], gain terms [R, C]) of one cycle: cand one EM step from
    the extrapolation of theta, t1, t2 by the row sums [R, 1] of r * r and
    v * v, the terms those of cand's intensities over t2's; with
    ``intensities`` (a block's last cycle) also those of t2 and of cand
    [R, C], which the last pass sums anyway.  reads and eumaps [C] or
    [R, C], inv_denom [T] or [R, T].  One launch on the card, ceil(R /
    ``plan.rows``) x ``plan.n_tiles`` clusters."""
    global EXTRAP_GAIN_LAUNCHES
    if theta.device.type == "cpu":
        return extrap_gain_ref(theta, t1, t2, r_sq_sum, v_sq_sum,
                               plan.by_cid, plan.by_tid, reads, eumaps,
                               inv_denom, intensities=intensities)
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
    terms = theta.new_empty((R, C))
    cand = torch.empty_like(theta)
    s_pair = ((torch.empty_like(terms), torch.empty_like(terms))
              if intensities else (None, None))
    rc = _fn("emsar_cluster_extrap_gain", theta.dtype)(
        theta.data_ptr(), t1.data_ptr(), t2.data_ptr(), r_sq_sum.data_ptr(),
        v_sq_sum.data_ptr(), *plan.args(), reads.data_ptr(),
        eumaps.data_ptr(), inv_denom.data_ptr(), cand.data_ptr(),
        terms.data_ptr(), *(None if t is None else t.data_ptr()
                            for t in s_pair), R, C, T, plan.n_tiles,
        plan.rows, plan.smem, rs, inv_s, plan.cluster,
        torch.cuda.current_stream(theta.device).cuda_stream)
    _raise_on(rc, what)
    EXTRAP_GAIN_LAUNCHES += 1
    return (cand, terms, *s_pair) if intensities else (cand, terms)
