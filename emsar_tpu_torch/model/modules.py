"""Sequence-sharing module decomposition.

Builds the segment/transcript graph (cid <-> tid) from the rsh index and
splits it into disjoint modules (connected components), with the
reference's EUMAcut feedback loop: if any module exceeds
MAX_NTID_PER_SID transcripts, multi-transcript segments with
adjEUMA < EUMAcut are excluded and the decomposition restarts with
EUMAcut += 2 (reference: propagate_2 src/emsar_functions.c:2234-2258 and
the driver loop src/emsar_main.c:411-425).

The reference uses a recursive DFS; here it's an iterative union-find on
the host (cheap, irregular), producing flat arrays for the device solver.
Set ids are numbered by the smallest participating cid, matching the
reference's assignment order for output parity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import EUMACUT_INCREMENT, MAX_NTID_PER_SID


@dataclasses.dataclass
class SegmentGraph:
    """CSR cid -> tid multiplicity graph in canonical cid order.

    cids 0..ntid-1 are the single-transcript segments; multi segments
    follow.  ``ct_tids`` keeps duplicate tids (internal repeats) exactly
    as the reference's CT arrays do.
    """

    n_transcripts: int
    ct_offsets: np.ndarray  # int64 [n_cid + 1]
    ct_tids: np.ndarray  # int32 flat
    adj_euma: np.ndarray  # float64 [n_cid]
    read_count: np.ndarray  # int64 [n_cid]

    @property
    def n_cid(self) -> int:
        return len(self.ct_offsets) - 1


def build_segment_graph(index, adj_euma: np.ndarray,
                        read_count: np.ndarray) -> SegmentGraph:
    """Assemble the CSR graph from an RshIndex + per-cid arrays."""
    ntid = index.n_transcripts
    single_off = np.arange(ntid + 1, dtype=np.int64)
    multi_off = index.sig_offsets + ntid
    ct_offsets = np.concatenate([single_off, multi_off[1:]])
    ct_tids = np.concatenate([
        np.arange(ntid, dtype=np.int32), index.sig_tids.astype(np.int32)])
    return SegmentGraph(n_transcripts=ntid, ct_offsets=ct_offsets,
                        ct_tids=ct_tids, adj_euma=adj_euma,
                        read_count=read_count)


def _connected_roots(ntid: int, off: np.ndarray, tids: np.ndarray,
                     sizes: np.ndarray, act_multi: np.ndarray) -> np.ndarray:
    """Per-tid component root (the smallest tid of the component), with
    components induced by the active multi-transcript segments.

    Vectorized: star edges (first tid of each segment -> its other tids)
    fed to scipy's C connected-components; falls back to iterative
    min-label propagation without scipy."""
    if len(act_multi) == 0:
        return np.arange(ntid, dtype=np.int64)
    e_sizes = sizes[act_multi] - 1
    first = np.repeat(tids[off[act_multi]], e_sizes).astype(np.int64)
    n_e = int(e_sizes.sum())
    estart = np.zeros(len(act_multi) + 1, dtype=np.int64)
    np.cumsum(e_sizes, out=estart[1:])
    within = np.arange(n_e, dtype=np.int64) - np.repeat(estart[:-1], e_sizes)
    other = tids[np.repeat(off[act_multi] + 1, e_sizes) + within] \
        .astype(np.int64)
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components
        g = coo_matrix((np.ones(n_e, dtype=np.int8), (first, other)),
                       shape=(ntid, ntid))
        _, labels = connected_components(g, directed=False)
        # root = smallest tid per component label
        root_of_label = np.full(labels.max() + 1, ntid, dtype=np.int64)
        np.minimum.at(root_of_label, labels, np.arange(ntid, dtype=np.int64))
        return root_of_label[labels]
    except ImportError:
        labels = np.arange(ntid, dtype=np.int64)
        while True:
            m = np.minimum(labels[first], labels[other])
            prev = labels.copy()
            np.minimum.at(labels, first, m)
            np.minimum.at(labels, other, m)
            # pointer-jump to each node's current label's label
            labels = labels[labels]
            if np.array_equal(labels, prev):
                return labels


@dataclasses.dataclass
class ModuleDecomposition:
    cs: np.ndarray  # int64 [n_cid]: cid -> set id, -1 if excluded
    ts: np.ndarray  # int64 [ntid]: tid -> set id
    n_sets: int
    euma_cut: float


def decompose_modules(graph: SegmentGraph, euma_cut: float = 0.0,
                      max_ntid_per_sid: int = MAX_NTID_PER_SID,
                      verbose: int = 0, fail_on_oversize: bool = False
                      ) -> Optional[ModuleDecomposition]:
    """Union tids through active segments; raise EUMAcut until every module
    has <= max_ntid_per_sid transcripts.

    At euma_cut == 0 the active set is every segment (the reference cut
    is strict '<', propagate_2 src/emsar_functions.c:2242), so the
    decomposition is a pure function of the INDEX — sample-independent —
    unless the oversize loop raises the cut (then adjEUMA values
    matter).  ``fail_on_oversize`` returns None instead of looping, so
    callers can cache the index-only result (see quantify.index_modules)
    and fall back to the data-dependent loop only when needed."""
    ntid = graph.n_transcripts
    n_cid = graph.n_cid
    off, tids = graph.ct_offsets, graph.ct_tids
    sizes = np.diff(off)
    multi_mask = sizes > 1

    while True:
        # active segments participate in the union: all singles, and multi
        # segments with adjEUMA >= EUMAcut (reference propagate_2 :2242 —
        # the cut is strict '<', so adjEUMA == EUMAcut == 0 still joins).
        active = ~multi_mask | (graph.adj_euma >= euma_cut)

        roots = _connected_roots(ntid, off, tids, sizes,
                                 np.flatnonzero(active & multi_mask))

        comp_sizes = np.bincount(roots, minlength=ntid)
        # component tid-count == number of tids whose root is r
        if comp_sizes.max(initial=0) > max_ntid_per_sid:
            if fail_on_oversize:
                return None
            euma_cut += EUMACUT_INCREMENT
            if verbose:
                print(f"[emsar] module too big "
                      f"({int(comp_sizes.max())}); EUMAcut -> {euma_cut:.0f}")
            continue

        # set ids numbered by smallest active cid, as the reference's
        # propagate order does.  Every tid owns single cid == tid, and
        # singles are always active, so the smallest cid of a component is
        # the smallest tid in it == the component root (union by min).
        cs = np.full(n_cid, -1, dtype=np.int64)
        first_tid = tids[off[:ntid]]  # == arange(ntid)
        # root per cid (via its first tid); actives only
        cid_root = roots[tids[off[np.arange(n_cid)]]]
        # order sets by root tid (== smallest cid in the set)
        uniq_roots = np.unique(roots)
        root_to_sid = np.full(ntid, -1, dtype=np.int64)
        root_to_sid[uniq_roots] = np.arange(len(uniq_roots))
        cs[active] = root_to_sid[cid_root[active]]
        ts = root_to_sid[roots]
        return ModuleDecomposition(cs=cs, ts=ts, n_sets=len(uniq_roots),
                                   euma_cut=euma_cut)
