"""The plain quantification reference and the comparison that decides
``correct`` for a quantification cell.

From the alignments the benchmark generated and the index it built (never
from anything the program made) it counts each read into its segment, as
the reference quantifier does (update_ReadCounts of EMSAR: a read's
signature is the sorted multiset of the transcripts it aligns to, duplicate
(transcript, position) pairs dropped; reads with more than ``max_repeat``
alignments are not counted; a read counts towards a single-transcript
segment only where the index has one, and towards a multi-transcript
segment only where the index has its signature; every read in the
fragment-length range counts towards the total).  It then maximises the
same Poisson likelihood as the program,

    F(theta) = sum_c R_c log(E_c s_c) - E_c s_c,  s_c = sum_t m_ct theta_t,

E_c = adjEUMA_c / 1e3 * total / 1e6, by EM accelerated with SQUAREM, a step
length and a monotone accept per module (the connected parts of the
segment-transcript graph), to a far tighter stop than the program's.

Transcript abundances are not identifiable inside collinear isoform groups,
so the comparison holds the program's ``.fpkm`` to what is:

* ``loglik_gap``: the reference's maximum of F less F at the program's
  FPKM column, in logL units: the solve reached the maximum;
* ``count_gap``: per module, the program's iReadcount summed against the
  module's reads (equal after every EM step, whatever the step, to the
  precision of the arithmetic), the largest gap;
* ``efflen_gap``: the eff.length column against the reference's iEUMA;
* ``fraglen_gap``: the ``.fraglength_effect`` counts against the
  reference's fragment-length histogram.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .gen import Alignments
from .refbuild import Index


@dataclasses.dataclass
class Counts:
    read_count: np.ndarray  # int64 [n_cid]: singles, then multis
    total: int
    fraglen_hist: Dict[int, int]


def count_reads(index: Index, aln: Alignments, max_repeat: int = 100
                ) -> Counts:
    """Each read of ``aln`` into its segment of ``index`` (SE reads of the
    index's read length, so every read is in the fragment-length range)."""
    ntid = len(index.names)
    o = np.lexsort((aln.pos, aln.tid, aln.read))
    read, tid, pos = aln.read[o], aln.tid[o], aln.pos[o]
    dup = np.concatenate([[False], (read[1:] == read[:-1])
                          & (tid[1:] == tid[:-1]) & (pos[1:] == pos[:-1])])
    read, tid = read[~dup], tid[~dup]
    n = np.bincount(read, minlength=aln.n_reads)
    kept = (n >= 1) & (n <= max_repeat)
    total = int(kept.sum())
    line_kept = kept[read]
    read, tid = read[line_kept], tid[line_kept]  # sorted by (read, tid)
    size = n[read]
    first = np.concatenate([[True], read[1:] != read[:-1]])
    counts = np.zeros(ntid + len(index.multi), dtype=np.int64)

    one = first & (size == 1)
    t1 = tid[one]
    t1 = t1[index.single[t1] > 0]
    np.add.at(counts, t1, 1)

    sig_sizes = np.diff(index.sig_offsets)
    for s in np.unique(size[size > 1]):
        at = np.flatnonzero(first & (size == s))
        rows = tid[at[:, None] + np.arange(s)].astype(np.int64)
        rows_i = np.flatnonzero(sig_sizes == s)
        sig_rows = index.sig_tids[index.sig_offsets[rows_i][:, None]
                                  + np.arange(s)].astype(np.int64)
        both = np.ascontiguousarray(np.concatenate([sig_rows, rows]))
        _, inv = np.unique(both.view(np.dtype((np.void, 8 * s))),
                           return_inverse=True)
        inv = inv.ravel()
        row_of_group = np.full(inv.max() + 1, -1, dtype=np.int64)
        row_of_group[inv[:len(rows_i)]] = rows_i
        hit = row_of_group[inv[len(rows_i):]]
        hit = hit[hit >= 0]
        np.add.at(counts, ntid + hit, 1)
    return Counts(read_count=counts, total=total,
                  fraglen_hist={index.readlength: total})


@dataclasses.dataclass
class Problem:
    """The likelihood's arrays on a torch device."""

    cid: torch.Tensor  # [edges] segment of each edge (active segments)
    tid: torch.Tensor  # [edges]
    mult: torch.Tensor  # [edges]
    reads: torch.Tensor  # [segments]
    eumaps: torch.Tensor  # [segments]
    denom: torch.Tensor  # [ntid]
    module_of_seg: torch.Tensor  # [segments]
    module_of_tid: torch.Tensor  # [ntid]
    n_modules: int
    ieuma: np.ndarray  # float64 [ntid]


def problem(index: Index, counts: Counts, device, dtype=torch.float64
            ) -> Problem:
    """The likelihood of a sample: every segment with EUMA, its edges to
    its transcripts with their multiplicities, and the modules."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    ntid = len(index.names)
    # SE at one read length: Wf is 1 at that length, so adjEUMA = EUMA
    adj = np.concatenate([index.single, index.multi]).astype(np.float64)
    sizes = np.concatenate([np.ones(ntid, np.int64),
                            np.diff(index.sig_offsets)])
    seg_tids = np.concatenate([np.arange(ntid), index.sig_tids])
    seg_of = np.repeat(np.arange(len(adj)), sizes)
    ieuma = np.bincount(seg_tids, weights=adj[seg_of], minlength=ntid)
    eumaps = adj / 1e3 * (counts.total / 1e6)
    active = eumaps[seg_of] > 0
    key = np.unique(seg_of[active] * ntid + seg_tids[active],
                    return_counts=True)
    e_seg, e_tid, mult = key[0] // ntid, key[0] % ntid, key[1]
    segs, e_seg = np.unique(e_seg, return_inverse=True)
    n_seg = len(segs)
    g = coo_matrix((np.ones(len(e_tid)), (e_tid, ntid + e_seg)),
                   shape=(ntid + n_seg, ntid + n_seg))
    n_mod, label = connected_components(g, directed=False)
    E = eumaps[segs]
    denom = np.bincount(e_tid, weights=mult * E[e_seg], minlength=ntid)

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)
    return Problem(cid=t(e_seg, torch.int64),
                   tid=t(e_tid, torch.int64), mult=t(mult),
                   reads=t(counts.read_count[segs]), eumaps=t(E),
                   denom=t(denom), module_of_seg=t(label[ntid:], torch.int64),
                   module_of_tid=t(label[:ntid], torch.int64),
                   n_modules=int(n_mod), ieuma=ieuma)


def _intensity(p: Problem, theta: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(p.reads.shape[0], dtype=theta.dtype, device=theta.device)
    return s.index_add_(0, p.cid, p.mult * theta[p.tid])


def em_step(p: Problem, theta: torch.Tensor) -> torch.Tensor:
    s = _intensity(p, theta)
    ratio = torch.where(p.reads > 0, p.reads / s, torch.zeros_like(s))
    g = torch.zeros_like(theta).index_add_(0, p.tid, p.mult * ratio[p.cid])
    return torch.where(p.denom > 0, theta * g / p.denom,
                       torch.zeros_like(theta))


def loglik_by_module(p: Problem, theta: torch.Tensor) -> torch.Tensor:
    lam = p.eumaps * _intensity(p, theta)
    term = torch.where(p.reads > 0, p.reads * torch.log(lam),
                       torch.zeros_like(lam)) - lam
    out = torch.zeros(p.n_modules, dtype=theta.dtype, device=theta.device)
    return out.index_add_(0, p.module_of_seg, term)


def _by_module(p: Problem, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(p.n_modules, dtype=x.dtype, device=x.device)
    return out.index_add_(0, p.module_of_tid, x)


def solve(p: Problem, max_cycles: int = 20000, check_every: int = 25,
          rel_tol: float = 1e-14) -> torch.Tensor:
    """The maximum of F by SQUAREM (step length and accept per module),
    stopped once F rose by no more than ``rel_tol`` of its size over
    ``check_every`` cycles, or after ``max_cycles``."""
    theta = torch.where(p.denom > 0, torch.ones_like(p.denom),
                        torch.zeros_like(p.denom))
    theta = em_step(p, theta)
    ll = loglik_by_module(p, theta)
    last = ll.clone()
    for cycle in range(1, max_cycles + 1):
        t1 = em_step(p, theta)
        t2 = em_step(p, t1)
        r = t1 - theta
        v = t2 - 2 * t1 + theta
        rr = _by_module(p, r * r)
        vv = _by_module(p, v * v)
        alpha = torch.where(vv > 0, -torch.sqrt(rr / vv),
                            -torch.ones_like(vv)).clamp(max=-1.0)
        a = alpha[p.module_of_tid]
        cand = theta - 2 * a * r + a * a * v
        # a step that would zero a transcript EM keeps alive is not taken:
        # EM cannot bring back a transcript it has once set to 0
        lost = _by_module(p, ((cand <= 0) & (t2 > 0)).to(theta.dtype)) > 0
        cand = em_step(p, cand.clamp(min=0))
        ll_c = loglik_by_module(p, cand)
        ll_2 = loglik_by_module(p, t2)
        take = (ll_c >= ll_2) & torch.isfinite(ll_c) & ~lost
        theta = torch.where(take[p.module_of_tid], cand, t2)
        ll = torch.where(take, ll_c, ll_2)
        if cycle % check_every == 0:
            rise = (ll.sum() - last.sum()) / ll.sum().abs().clamp(min=1.0)
            if not float(rise) > rel_tol:
                break
            last = ll.clone()
    return theta


class Reference:
    """What a sample's outputs are held to: its read counts, its
    likelihood, the reads of each module."""

    def __init__(self, index: Index, aln: Alignments, device):
        self.counts = count_reads(index, aln)
        self.problem = problem(index, self.counts, device)
        p = self.problem
        mreads = torch.zeros(p.n_modules, dtype=torch.float64, device=device)
        mreads.index_add_(0, p.module_of_seg, p.reads)
        self.module_reads = mreads.cpu().numpy()
        self.names = index.names
        self._loglik = None

    def loglik(self) -> float:
        """F at the reference's maximum, in float64."""
        if self._loglik is None:
            theta = solve(self.problem)
            self._loglik = float(loglik_by_module(self.problem, theta).sum())
        return self._loglik


def read_fpkm(path: str):
    """(names, FPKM, eff.length, iReadcount) of an ``.fpkm`` file."""
    with open(path) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    col = {h: i for i, h in enumerate(head)}
    names = [r[0] for r in rows]

    def get(h):
        return np.array([float(r[col[h]]) for r in rows])
    return names, get("FPKM"), get("eff.length"), get("iReadcount")


def read_fraglen(path: str) -> Dict[int, int]:
    with open(path) as fh:
        next(fh)
        return {int(r.split("\t")[0]): int(r.split("\t")[1]) for r in fh}


def judge(ref: Reference, fpkm_path: str, fraglen_path: str
          ) -> Dict[str, float]:
    """The numbers compared for one sample's outputs (each: larger is
    worse)."""
    p = ref.problem
    names, fpkm, efflen, ireadcount = read_fpkm(fpkm_path)
    if names != ref.names:
        return {k: float("inf") for k in ("loglik_gap", "count_gap",
                                          "efflen_gap", "fraglen_gap")}
    irc = _by_module(p, torch.as_tensor(ireadcount, dtype=torch.float64,
                                        device=p.denom.device))
    obs = read_fraglen(fraglen_path)
    hist = ref.counts.fraglen_hist
    return {"loglik_gap": loglik_gap(ref, fpkm),
            "count_gap": float(np.abs(irc.cpu().numpy()
                                      - ref.module_reads).max()),
            "efflen_gap": float(np.abs(efflen - p.ieuma).max()),
            "fraglen_gap": float(sum(abs(obs.get(k, 0) - hist.get(k, 0))
                                     for k in set(obs) | set(hist)))}


def loglik_gap(ref: Reference, fpkm: np.ndarray) -> float:
    """The reference's maximum of F less F at ``fpkm`` (an ``.fpkm``'s FPKM
    column)."""
    theta = torch.as_tensor(fpkm, dtype=torch.float64,
                            device=ref.problem.denom.device)
    gap = ref.loglik() - float(loglik_by_module(ref.problem, theta).sum())
    return gap if np.isfinite(gap) else float("inf")


def write_fpkm(path: str, names, theta: np.ndarray, ieuma: np.ndarray,
               total: int, dtype=np.float64) -> None:
    """An ``.fpkm`` of ``theta`` in the program's layout (the control's
    outputs; sd.of.FPKM 0), every column computed in ``dtype``."""
    th = theta.astype(dtype)
    irc = (ieuma.astype(dtype) / dtype(1e3)) * th * dtype(total / 1e6)
    tpm = th * dtype(1e6) / th.sum(dtype=dtype)
    with open(path, "w") as fh:
        fh.write("transcriptID\tFPKM\tsd.of.FPKM\teff.length\tiReadcount\t"
                 "iReadcount.int\tTPM\n")
        for t, n in enumerate(names):
            fh.write(f"{n}\t{float(th[t]):.6f}\t0.000000\t"
                     f"{float(ieuma[t]):.6f}\t{float(irc[t]):.6f}\t"
                     f"{int(float(irc[t]) + 0.5)}\t{float(tpm[t]):.6f}\n")


def write_fraglen(path: str, hist: Dict[int, int]) -> None:
    with open(path, "w") as fh:
        fh.write("Fragment.length\tObs.Counts\t"
                 "normalized.Fragment.length.sampling.prob\n")
        for k in sorted(hist):
            fh.write(f"{k}\t{hist[k]}\t1\n")


def control_outputs(ref: Reference, out_prefix: str) -> None:
    """The control: the reference put in the program's place and solved in
    float32, one precision below the configuration's float64; its columns
    written from that solution in float64, as the program writes its own."""
    p = ref.problem
    p32 = dataclasses.replace(
        p, mult=p.mult.float(), reads=p.reads.float(), eumaps=p.eumaps.float(),
        denom=p.denom.float())
    theta = solve(p32).double().cpu().numpy()
    write_fpkm(out_prefix + ".fpkm", ref.names, theta, p.ieuma,
               ref.counts.total)
    write_fraglen(out_prefix + ".fraglength_effect", ref.counts.fraglen_hist)


def fault_outputs(ref: Reference, out_prefix: str) -> None:
    """A fault planted in the reference put in the program's place: every
    step after the solve's first EM step returns its state unchanged."""
    theta = solve(ref.problem, max_cycles=0).cpu().numpy()
    write_fpkm(out_prefix + ".fpkm", ref.names, theta, ref.problem.ieuma,
               ref.counts.total)
    write_fraglen(out_prefix + ".fraglength_effect", ref.counts.fraglen_hist)
