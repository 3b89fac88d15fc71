"""The rsh ("read-sharing") index.

An rsh index maps every *mapping signature* — a sorted multiset of transcript
occurrences sharing an identical read (SE) or fragment (PE) sequence — to its
EUMA vector: for each fragment length, the number of distinct shared
sequences with that signature.

Canonical segment (cid) ordering, matching the reference file layout
(print_rsh, reference src/emsar_functions.c:2071-2130):

* cids ``0 .. max_tid``: the single-transcript segments, in tid order
  (a tid with no uniquely mapping sequence still owns an empty cid);
* then multi-transcript segments sorted by (signature size, tid tuple).

Storage here is dense + CSR: ``single_euma [ntid, nFraglen]`` and
(``sig_offsets``, ``sig_tids``, ``multi_euma [n_multi, nFraglen]``).

File formats:

* ``.rsh`` text — byte-compatible with the reference reader/writer
  (construct_rsh_from_rshfile / print_rsh);
* ``.rsh.npz`` sidecar — the arrays, loads orders of magnitude faster.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..config import INIT_RSHBUCKET_MAX_T_SIZE


@dataclasses.dataclass
class RshIndex:
    names: List[str]
    readlength: int  # -1 for SE (reference writes -1 in the header for SE)
    min_fraglength: int  # header field 3 (already clamped >= readlength at build)
    max_fraglength: int  # header field 4
    single_euma: np.ndarray  # int64 [ntid, nFraglen]
    sig_offsets: np.ndarray  # int64 [n_multi + 1]
    sig_tids: np.ndarray  # int32 flat, full sorted multiset incl. first tid
    multi_euma: np.ndarray  # int64 [n_multi, nFraglen]

    _sig_lookup: Optional[Dict[bytes, int]] = dataclasses.field(default=None, repr=False)

    # ---- derived quantities -------------------------------------------------

    @property
    def n_transcripts(self) -> int:
        return len(self.names)

    @property
    def max_tid(self) -> int:
        return len(self.names) - 1

    @property
    def fraglen_min(self) -> int:
        """Effective fragment-length range start (reference:
        determine_fraglength_range, src/emsar_functions.c:2471-2475)."""
        return max(self.min_fraglength, self.readlength)

    @property
    def fraglen_max(self) -> int:
        return max(self.max_fraglength, self.fraglen_min)

    @property
    def n_fraglen(self) -> int:
        return self.fraglen_max - self.fraglen_min + 1

    @property
    def n_multi(self) -> int:
        return self.multi_euma.shape[0]

    @property
    def n_cid(self) -> int:
        """max_cid + 1 == n_transcripts + n_multi."""
        return self.n_transcripts + self.n_multi

    @property
    def has_single(self) -> np.ndarray:
        """Whether tid has a single-transcript segment with nonzero EUMA
        (an absent bucket node in the reference).  Reads mapping uniquely to
        a tid without one are not counted (reference:
        update_rshbucket_single type 'r', src/emsar_functions.c:1528-1536)."""
        return self.single_euma.any(axis=1)

    @property
    def max_t_size(self) -> int:
        """Header field 2: the reference's rshbucket_max_t_size — starts at
        INIT_RSHBUCKET_MAX_T_SIZE (10) and only grows."""
        if self.n_multi == 0:
            return INIT_RSHBUCKET_MAX_T_SIZE
        sizes = np.diff(self.sig_offsets)
        return max(INIT_RSHBUCKET_MAX_T_SIZE, int(sizes.max()))

    def sig_sizes(self) -> np.ndarray:
        return np.diff(self.sig_offsets).astype(np.int32)

    def sig_lookup(self) -> Dict[bytes, int]:
        """Map from a signature's int32-tid-multiset bytes to multi row id."""
        if self._sig_lookup is None:
            off = self.sig_offsets
            tids = np.ascontiguousarray(self.sig_tids, dtype=np.int32)
            self._sig_lookup = {
                tids[off[i]:off[i + 1]].tobytes(): i for i in range(self.n_multi)
            }
        return self._sig_lookup

    def signature(self, row: int) -> np.ndarray:
        return self.sig_tids[self.sig_offsets[row]:self.sig_offsets[row + 1]]

    # ---- text format --------------------------------------------------------

    def write_text(self, path: str) -> None:
        """Write the reference-compatible .rsh text format, byte-identical to
        print_rsh (reference src/emsar_functions.c:2071-2130)."""
        nfl = self.n_fraglen
        with open(path, "w", buffering=1 << 20) as fh:
            fh.write(f"#{self.max_tid},{self.max_t_size},{self.fraglen_min},"
                     f"{self.fraglen_max},{self.readlength}\n")
            for j, name in enumerate(self.names):
                fh.write(f"@{j}\t{name}\n")
            fh.write("cid\tno.tids\tfirst.tid\tother.tids\tsegment.length\n")
            # single-transcript segments (.tolist() first: Python-int rows
            # format ~2x faster than numpy scalars — the human F1-400
            # index holds 462k rows x 300 EUMA columns)
            has = self.has_single
            single_rows = self.single_euma[:, :nfl].tolist()
            cid = 0
            for j in range(self.n_transcripts):
                if not has[j]:
                    fh.write(f"{cid}\t1\t{j}\t\t\t\n")
                else:
                    euma = ",".join(map(str, single_rows[j]))
                    fh.write(f"{cid}\t1\t{j}\t\t{euma},\n")
                cid += 1
            # multi-transcript segments, already in canonical (size, tuple) order
            off = self.sig_offsets
            multi_rows = self.multi_euma[:, :nfl].tolist()
            sig_list = self.sig_tids.tolist()
            for r in range(self.n_multi):
                tids = sig_list[off[r]:off[r + 1]]
                others = "".join(f"{t}," for t in tids[1:])
                euma = ",".join(map(str, multi_rows[r]))
                fh.write(f"{cid}\t{len(tids)}\t{tids[0]}\t{others}\t{euma},\n")
                cid += 1

    @staticmethod
    def read_text(path: str) -> "RshIndex":
        """Parse the reference .rsh text format (reference:
        construct_rsh_from_rshfile / parse_rsh_*line,
        src/emsar_functions.c:1351-1510)."""
        names: List[str] = []
        max_tid = -1
        readlength = None
        min_frag = max_frag = None
        single_rows: Dict[int, np.ndarray] = {}
        multi_sigs: List[np.ndarray] = []
        multi_rows: List[np.ndarray] = []

        with open(path, "r", buffering=1 << 20) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                c0 = line[0]
                if c0 == "#":
                    fields = line[1:].split(",")
                    max_tid = int(fields[0])
                    # fields[1] = max_t_size (derived on our side)
                    min_frag = int(fields[2])
                    max_frag = int(fields[3])
                    readlength = int(fields[4])
                    names = [""] * (max_tid + 1)
                elif c0 == "@":
                    tid_s, name = line[1:].split("\t", 1)
                    names[int(tid_s)] = name
                elif c0 == "c" and line.startswith("cid\t"):
                    continue  # column headings
                else:
                    parts = line.split("\t")
                    t_size = int(parts[1])
                    tid0 = int(parts[2])
                    eumastr = parts[4] if len(parts) > 4 else ""
                    if not eumastr:
                        continue  # empty segment (no node in the reference)
                    euma = np.array([int(x) for x in eumastr.split(",") if x != ""],
                                    dtype=np.int64)
                    if t_size == 1:
                        single_rows[tid0] = euma
                    else:
                        others = parts[3]
                        tids = np.empty(t_size, dtype=np.int32)
                        tids[0] = tid0
                        rest = [int(x) for x in others.split(",") if x != ""]
                        tids[1:] = rest
                        multi_sigs.append(tids)
                        multi_rows.append(euma)

        if readlength is None:
            raise ValueError(f"{path}: missing rsh header line")
        fraglen_min = max(min_frag, readlength)
        nfl = max(max_frag, fraglen_min) - fraglen_min + 1

        ntid = max_tid + 1
        single_euma = np.zeros((ntid, nfl), dtype=np.int64)
        for tid, row in single_rows.items():
            single_euma[tid, : len(row)] = row[:nfl]

        n_multi = len(multi_sigs)
        sizes = np.fromiter((len(s) for s in multi_sigs), dtype=np.int64, count=n_multi)
        sig_offsets = np.zeros(n_multi + 1, dtype=np.int64)
        np.cumsum(sizes, out=sig_offsets[1:])
        sig_tids = (np.concatenate(multi_sigs) if n_multi else
                    np.empty(0, dtype=np.int32)).astype(np.int32)
        multi_euma = np.zeros((n_multi, nfl), dtype=np.int64)
        for r, row in enumerate(multi_rows):
            multi_euma[r, : len(row)] = row[:nfl]

        return RshIndex(names=names, readlength=readlength,
                        min_fraglength=min_frag, max_fraglength=max_frag,
                        single_euma=single_euma, sig_offsets=sig_offsets,
                        sig_tids=sig_tids, multi_euma=multi_euma)

    # ---- npz sidecar --------------------------------------------------------

    def write_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            names=np.array(self.names, dtype=object),
            header=np.array([self.readlength, self.min_fraglength,
                             self.max_fraglength], dtype=np.int64),
            single_euma=self.single_euma,
            sig_offsets=self.sig_offsets,
            sig_tids=self.sig_tids,
            multi_euma=self.multi_euma,
        )

    @staticmethod
    def read_npz(path: str) -> "RshIndex":
        with np.load(path, allow_pickle=True) as z:
            rl, mn, mx = (int(x) for x in z["header"])
            return RshIndex(names=[str(n) for n in z["names"]],
                            readlength=rl, min_fraglength=mn, max_fraglength=mx,
                            single_euma=z["single_euma"],
                            sig_offsets=z["sig_offsets"],
                            sig_tids=z["sig_tids"],
                            multi_euma=z["multi_euma"])

    @staticmethod
    def merge(parts: List["RshIndex"]) -> "RshIndex":
        """Sum per-shard partial indexes (process-sharded builds).

        Cluster shards partition the reference's run space
        (process_mate1_cluster_by_mate_3 owns each mate1 cluster exactly
        once, src/emsar_functions.c:2839), so partial EUMA counts add:
        single-transcript rows add per tid, multi rows merge by identical
        tid multiset, and the canonical (size, tuple) row order is
        restored over the union."""
        base = parts[0]
        for p in parts[1:]:
            if (p.names != base.names or p.readlength != base.readlength
                    or p.min_fraglength != base.min_fraglength
                    or p.max_fraglength != base.max_fraglength):
                raise ValueError("partial indexes disagree on header")
        single = np.zeros_like(base.single_euma)
        for p in parts:
            single += p.single_euma
        acc: Dict[bytes, np.ndarray] = {}
        sig_of: Dict[bytes, np.ndarray] = {}
        for p in parts:
            off = p.sig_offsets
            tids = np.ascontiguousarray(p.sig_tids, dtype=np.int32)
            for i in range(p.n_multi):
                key = tids[off[i]:off[i + 1]].tobytes()
                row = acc.get(key)
                if row is None:
                    acc[key] = p.multi_euma[i].astype(np.int64).copy()
                    sig_of[key] = tids[off[i]:off[i + 1]]
                else:
                    row += p.multi_euma[i]
        order = sorted(acc, key=lambda k: (len(k), tuple(sig_of[k])))
        n_multi = len(order)
        nfl = base.n_fraglen
        multi = np.zeros((n_multi, nfl), dtype=np.int64)
        offs = np.zeros(n_multi + 1, dtype=np.int64)
        tid_chunks = []
        for j, k in enumerate(order):
            multi[j] = acc[k]
            tid_chunks.append(sig_of[k])
            offs[j + 1] = offs[j] + len(sig_of[k])
        sig_tids = (np.concatenate(tid_chunks).astype(np.int32)
                    if tid_chunks else np.zeros(0, np.int32))
        return RshIndex(names=base.names, readlength=base.readlength,
                        min_fraglength=base.min_fraglength,
                        max_fraglength=base.max_fraglength,
                        single_euma=single, sig_offsets=offs,
                        sig_tids=sig_tids, multi_euma=multi)

    @staticmethod
    def load(path: str) -> "RshIndex":
        """Load from .npz sidecar if present and newer, else parse text."""
        import os

        npz = path + ".npz" if not path.endswith(".npz") else path
        if os.path.exists(npz) and (
            not os.path.exists(path) or not path.endswith(".rsh")
            or os.path.getmtime(npz) >= os.path.getmtime(path)
        ):
            try:
                return RshIndex.read_npz(npz)
            except Exception:
                pass
        return RshIndex.read_text(path)
