"""Dense-batched module solver, in PyTorch.

The port of ``emsar_tpu/model/dense.py``.  Most sequence-sharing modules
are small (a gene family: tens of segments x a handful of isoforms), so
modules are bucketed into padded size classes and solved as batched dense
EM:

    s     = M theta          (bmm, 'bct,bt->bc')
    num   = M^T (R / s)      (bmm, 'bct,bc->bt')
    theta = theta * num / denom

Oversized modules fall back to the CSR solver (model/solver.py).  Only the
COO coordinates of the mostly-zero membership tensor M cross to the device;
M is materialized there by a scatter-add of 1.0 (exact in any order).

``use_pallas=True`` runs each block of SQUAREM cycles in the hand-written
CUDA kernel ``kernels.squarem.squarem_block`` (the port of the Pallas
``_pallas_block``) inside a host convergence loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..kernels.squarem import squarem_block
from .modules import ModuleDecomposition, SegmentGraph
from .solver import gain_of, torch_dtype

# (max segments, max transcripts) per class; larger modules -> CSR
SIZE_CLASSES: Tuple[Tuple[int, int], ...] = ((32, 8), (64, 16), (128, 32),
                                             (512, 128))


@dataclasses.dataclass
class DenseBatch:
    """One padded size class of modules, in COO membership form.

    ``flat_idx`` holds b*C*T + ci*T + ti per (segment, transcript)
    incidence — duplicates encode multiplicity (internal repeats) and
    accumulate in the device scatter that materializes M.
    """

    shape: Tuple[int, int, int]  # (B, C, T)
    flat_idx: np.ndarray  # int32/int64 [nnz]
    eumaps: np.ndarray  # [B, C]
    reads: np.ndarray  # [B, C]
    tid_map: np.ndarray  # int32 [B, T], -1 padding
    sids: np.ndarray  # int64 [B]

    @property
    def m(self) -> np.ndarray:
        """Materialized [B, C, T] membership tensor (host, for tests)."""
        B, C, T = self.shape
        m = np.zeros(B * C * T, dtype=self.eumaps.dtype)
        np.add.at(m, self.flat_idx, 1.0)
        return m.reshape(B, C, T)


@dataclasses.dataclass
class DensePartition:
    batches: List[DenseBatch]
    csr_sids: np.ndarray  # modules left to the CSR solver


@dataclasses.dataclass
class DeviceBatch:
    """A DenseBatch's solve inputs on a torch device."""

    m: torch.Tensor  # [B, C, T]
    eumaps: torch.Tensor  # [B, C]
    reads: torch.Tensor  # [B, C]
    inv_denom: torch.Tensor  # [B, T]


def partition_modules(graph: SegmentGraph, modules: ModuleDecomposition,
                      eumaps: np.ndarray, read_count: np.ndarray,
                      classes: Tuple[Tuple[int, int], ...] = SIZE_CLASSES,
                      dtype=np.float32) -> DensePartition:
    """Bucket modules into dense size classes (fully vectorized).

    Active segments are those with sid >= 0 and EUMAps > 0 (reference
    skips E==0 segments in the likelihood, Fp src/emsar_functions.c:2952);
    transcripts are those appearing in a module's active segments."""
    ntid = graph.n_transcripts
    off, tids = graph.ct_offsets, graph.ct_tids
    seg_sizes = np.diff(off)
    active = (modules.cs >= 0) & (eumaps > 0)
    act_cids = np.flatnonzero(active)
    if len(act_cids) == 0:
        return DensePartition(batches=[],
                              csr_sids=np.empty(0, dtype=np.int64))

    cid_sid = modules.cs[act_cids]
    order = np.argsort(cid_sid, kind="stable")
    act_cids = act_cids[order]
    cid_sid = cid_sid[order]
    # modules present among active segments, as contiguous row ranges
    sids_u, first_pos, mod_ncid = np.unique(cid_sid, return_index=True,
                                            return_counts=True)
    nmod = len(sids_u)
    mod_row = np.repeat(np.arange(nmod, dtype=np.int64), mod_ncid)
    ci = np.arange(len(act_cids), dtype=np.int64) \
        - np.repeat(first_pos, mod_ncid)  # local segment index

    # flat (module, local segment, tid) incidences
    e_sizes = seg_sizes[act_cids]
    n_inc = int(e_sizes.sum())
    estart = np.zeros(len(act_cids) + 1, dtype=np.int64)
    np.cumsum(e_sizes, out=estart[1:])
    within = np.arange(n_inc, dtype=np.int64) - np.repeat(estart[:-1],
                                                          e_sizes)
    e_tid = tids[np.repeat(off[act_cids], e_sizes) + within].astype(np.int64)
    e_mod = np.repeat(mod_row, e_sizes)
    e_ci = np.repeat(ci, e_sizes)

    # per-module transcript lists (sorted) + local ranks
    key = e_mod * ntid + e_tid
    uniq = np.unique(key)
    u_mod = uniq // ntid
    u_tid = (uniq % ntid).astype(np.int32)
    mod_ntid = np.bincount(u_mod, minlength=nmod)
    u_start = np.zeros(nmod + 1, dtype=np.int64)
    np.cumsum(mod_ntid, out=u_start[1:])
    u_rank = np.arange(len(uniq), dtype=np.int64) \
        - np.repeat(u_start[:-1], mod_ntid)
    e_ti = u_rank[np.searchsorted(uniq, key)]

    # smallest fitting class per module; none -> CSR
    n_cls = len(classes)
    cls = np.full(nmod, n_cls, dtype=np.int64)
    for k in reversed(range(n_cls)):
        cmax, tmax = classes[k]
        cls = np.where((mod_ncid <= cmax) & (mod_ntid <= tmax), k, cls)
    csr_sids = sids_u[cls == n_cls]

    cls_of_cid = cls[mod_row]
    cls_of_inc = cls[e_mod]
    cls_of_u = cls[u_mod]
    batches: List[DenseBatch] = []
    for k, (cmax, tmax) in enumerate(classes):
        members = np.flatnonzero(cls == k)
        if len(members) == 0:
            continue
        B = len(members)
        brow = np.full(nmod, -1, dtype=np.int64)
        brow[members] = np.arange(B)

        emask = cls_of_inc == k
        flat = (brow[e_mod[emask]] * (cmax * tmax)
                + e_ci[emask] * tmax + e_ti[emask])
        flat_idx = flat.astype(np.int32 if B * cmax * tmax < 2**31
                               else np.int64)

        E_cls = np.zeros((B, cmax), dtype=dtype)
        R_cls = np.zeros((B, cmax), dtype=dtype)
        cmask = cls_of_cid == k
        rows, cols = brow[mod_row[cmask]], ci[cmask]
        E_cls[rows, cols] = eumaps[act_cids[cmask]]
        R_cls[rows, cols] = read_count[act_cids[cmask]]

        tid_map = np.full((B, tmax), -1, dtype=np.int32)
        umask = cls_of_u == k
        tid_map[brow[u_mod[umask]], u_rank[umask]] = u_tid[umask]

        batches.append(DenseBatch(shape=(B, cmax, tmax), flat_idx=flat_idx,
                                  eumaps=E_cls, reads=R_cls, tid_map=tid_map,
                                  sids=sids_u[members]))
    return DensePartition(batches=batches, csr_sids=csr_sids)


def _mt(m: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """'bct,...bt->...bc' for th [B, T] or [R, B, T] (R rides bmm's N)."""
    if th.dim() == 2:
        return torch.bmm(m, th[:, :, None])[:, :, 0]
    return torch.bmm(m, th.permute(1, 2, 0)).permute(2, 0, 1)


def _mc(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """'bct,...bc->...bt' for x [B, C] or [R, B, C]."""
    mT = m.transpose(1, 2)
    if x.dim() == 2:
        return torch.bmm(mT, x[:, :, None])[:, :, 0]
    return torch.bmm(mT, x.permute(1, 2, 0)).permute(2, 0, 1)


def _em_iter_dense(m, reads, inv_denom, theta):
    s = _mt(m, theta)
    pos = s > 0
    ratio = torch.where(pos, reads / torch.where(pos, s, 1.0), 0.0)
    return theta * _mc(m, ratio) * inv_denom


def _materialize(flat_idx: torch.Tensor, dtype: torch.dtype, B: int, C: int,
                 T: int) -> torch.Tensor:
    """COO coordinates -> dense [B, C, T] membership (device scatter-add
    of 1.0: small integers, exact in any order)."""
    m = torch.zeros(B * C * T, dtype=dtype, device=flat_idx.device)
    m.index_add_(0, flat_idx, torch.ones_like(flat_idx, dtype=dtype))
    return m.view(B, C, T)


def batch_to_device(batch: DenseBatch, device: torch.device,
                    dtype: torch.dtype) -> DeviceBatch:
    """Move a DenseBatch to ``device``: materialize M and the inverse
    denominator sum_c m_ct E_c there (``_prep_dense`` of the JAX code)."""
    B, C, T = batch.shape
    flat_idx = torch.as_tensor(batch.flat_idx.astype(np.int64)).to(device)
    eumaps = torch.as_tensor(batch.eumaps).to(device=device, dtype=dtype)
    reads = torch.as_tensor(batch.reads).to(device=device, dtype=dtype)
    m = _materialize(flat_idx, dtype, B, C, T)
    denom = _mc(m, eumaps)
    pos = denom > 0
    inv_denom = torch.where(pos, 1.0 / torch.where(pos, denom, 1.0), 0.0)
    return DeviceBatch(m=m, eumaps=eumaps, reads=reads, inv_denom=inv_denom)


def _theta0(db: DeviceBatch) -> torch.Tensor:
    """Read-attribution start: all of each segment's reads granted to every
    member transcript (exact zeros stay zero, which is their optimum)."""
    return _mc(db.m, db.reads) * db.inv_denom


def _solve_loop(db: DeviceBatch, theta0: torch.Tensor, epsilon: float,
                block_iters: int, max_blocks: int
                ) -> Tuple[torch.Tensor, int]:
    """SQUAREM EM from ``theta0`` [R, B, T] with the CSR solver's
    convergence semantics (termwise likelihood gains, per-module max).  A
    round stops when its best module's block gain drops below epsilon; the
    loop runs until every round has stopped or ``max_blocks``.  One host
    sync per block."""
    m, E, R, inv = db.m, db.eumaps, db.reads, db.inv_denom

    def cycle(th):
        t1 = _em_iter_dense(m, R, inv, th)
        t2 = _em_iter_dense(m, R, inv, t1)
        r = t1 - th
        v = t2 - t1 - r
        rn = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True))
        vn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        alpha = torch.where(vn > 0, -rn / torch.where(vn > 0, vn, 1.0), -1.0)
        alpha = torch.clamp(alpha, max=-1.0)
        # coordinates the extrapolation would clamp to 0 take the plain
        # double-EM value instead: an exact 0 is an absorbing boundary for
        # multiplicative EM and can freeze a suboptimal KKT point
        extrap = th - 2.0 * alpha * r + alpha * alpha * v
        cand = _em_iter_dense(m, R, inv, torch.where(extrap > 0, extrap, t2))
        better = gain_of(R, E, _mt(m, t2), _mt(m, cand)) >= 0
        return torch.where(better[..., None], cand, t2)

    th = theta0
    s_prev = _mt(m, th)
    active = torch.ones(th.shape[0], dtype=torch.bool, device=th.device)
    it = 0
    while True:
        new = th
        for _ in range(block_iters):
            new = cycle(new)
        s_new = _mt(m, new)
        gain = torch.amax(gain_of(R, E, s_prev, s_new), dim=-1)
        # rounds that already stopped keep their state (vmap'd while_loop)
        th = torch.where(active[:, None, None], new, th)
        s_prev = torch.where(active[:, None, None], s_new, s_prev)
        it += 1
        active = active & (gain >= epsilon)
        if not (it < max_blocks and bool(active.any())):
            break
    return th, it


def _dense_solve_pallas(db: DeviceBatch, epsilon: float, block_iters: int,
                        max_blocks: int) -> Tuple[torch.Tensor, int]:
    """The kernel path: each block of ``block_iters`` SQUAREM cycles is one
    ``squarem_block`` launch; between blocks the host evaluates the same
    termwise likelihood gain as ``_solve_loop``.  The loop syncs once per
    block through ``.item()`` (the JAX code keeps it in a device
    ``while_loop``; moving it onto the device or into CUDA graphs is
    queued)."""
    th = _theta0(db)
    s_prev = _mt(db.m, th)
    it = 0
    while True:
        th = squarem_block(db.m, db.eumaps, db.reads, db.inv_denom, th,
                           block_iters)
        s_new = _mt(db.m, th)
        gain = torch.max(gain_of(db.reads, db.eumaps, s_prev, s_new))
        s_prev = s_new
        it += 1
        if not (gain.item() >= epsilon and it < max_blocks):
            break
    return th, it


def subset_batch(batch: DenseBatch, rows: np.ndarray) -> DenseBatch:
    """The sub-batch of ``rows`` (module indices into the batch axis)."""
    B, C, T = batch.shape
    brow = np.full(B, -1, dtype=np.int64)
    brow[rows] = np.arange(len(rows))
    b_of = batch.flat_idx // (C * T)
    keep = brow[b_of] >= 0
    rem = batch.flat_idx[keep] - b_of[keep] * (C * T)
    flat = brow[b_of[keep]] * (C * T) + rem
    nB = len(rows)
    return DenseBatch(
        shape=(nB, C, T),
        flat_idx=flat.astype(np.int32 if nB * C * T < 2**31 else np.int64),
        eumaps=batch.eumaps[rows], reads=batch.reads[rows],
        tid_map=batch.tid_map[rows], sids=batch.sids[rows])


def _quantize_b(b: int) -> int:
    """Round the batch axis up to ~8 shapes per octave (<= 12.5% inert
    pad rows), as the JAX package does to bound its recompiles; kept so the
    two packages solve identically shaped batches."""
    if b <= 8:
        return 8
    p2 = 1 << (b - 1).bit_length()
    step = max(p2 // 8, 8)
    return -(-b // step) * step


def _pad_b(batch: DenseBatch) -> Tuple[DenseBatch, int]:
    """Pad the batch axis to a quantized size with inert rows (E = R = 0,
    no incidences: zero denominator, zero theta, zero likelihood gain)."""
    B, C, T = batch.shape
    Bp = _quantize_b(B)
    if Bp == B:
        return batch, B
    pad = Bp - B
    return DenseBatch(
        shape=(Bp, C, T), flat_idx=batch.flat_idx,
        eumaps=np.pad(batch.eumaps, ((0, pad), (0, 0))),
        reads=np.pad(batch.reads, ((0, pad), (0, 0))),
        tid_map=np.pad(batch.tid_map, ((0, pad), (0, 0)),
                       constant_values=-1),
        sids=np.pad(batch.sids, (0, pad), constant_values=-1)), B


def solve_dense_restarts(batch: DenseBatch, inits: np.ndarray,
                         epsilon: float, device: torch.device,
                         block_iters: int = 8,
                         max_blocks: int = 2048) -> np.ndarray:
    """Solve one dense size class from ``inits`` [R, B, T] (the restart
    rounds behind sd.of.FPKM); returns theta [R, B, T].  M and the
    denominator are materialized once and shared by all rounds."""
    batch, B0 = _pad_b(batch)
    B = batch.shape[0]
    if B != B0:
        inits = np.pad(inits, ((0, 0), (0, B - B0), (0, 0)))
    dtype = torch_dtype(batch.eumaps.dtype)
    db = batch_to_device(batch, device, dtype)
    th0 = torch.as_tensor(inits.astype(batch.eumaps.dtype)).to(device)
    th, _ = _solve_loop(db, th0, epsilon, block_iters, max_blocks)
    return th.cpu().numpy()[:, :B0]


def solve_dense_batch(batch: DenseBatch, epsilon: float,
                      device: torch.device, block_iters: int = 8,
                      max_blocks: int = 2048, use_pallas: bool = False
                      ) -> Tuple[np.ndarray, int]:
    """Solve one dense size class; returns (theta [B, T], n_blocks).
    ``use_pallas`` selects the hand-written CUDA kernel (the name follows
    the JAX package's flag); on CPU tensors the kernel's plain version
    runs."""
    B0 = batch.shape[0]
    dtype = torch_dtype(batch.eumaps.dtype)
    if not use_pallas:
        batch, B0 = _pad_b(batch)
        db = batch_to_device(batch, device, dtype)
        th, it = _solve_loop(db, _theta0(db)[None], epsilon, block_iters,
                             max_blocks)
        return th[0].cpu().numpy()[:B0], it
    db = batch_to_device(batch, device, dtype)
    th, it = _dense_solve_pallas(db, epsilon, block_iters, max_blocks)
    return th.cpu().numpy(), it
