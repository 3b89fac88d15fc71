"""The plain SE index builder: the benchmark's own, in plain PyTorch.

It makes the ``-I`` index of a quantification cell (the configuration's
data, built once per checkout) and is the reference that a build cell's
``.rsh`` is held to.  It follows the semantics of the reference builder
(``emsar-build``; preprocess_SE + construct_rshbucket_2 of EMSAR): every
all-ACGT window of the forward strand is keyed by its sequence (unstranded:
the lesser of the window and its reverse complement), windows are grouped
by key, and a group of L windows adds one to the EUMA of the sorted
multiset of its transcripts: a single-transcript segment when L == 1,
nothing when L >= max_repeat.  Segments are ordered singles by transcript,
then multi-transcript signatures by (size, tuple).

Keys are exact: 31 bases a 62-bit word, compared word by word.  With
``key_bits`` the key is cut to a hash of that many bits instead: the
control of the build cell, a tempting shortcut that merges windows whose
hashes collide.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

WORD = 31  # bases in one int64 key word

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _CODE[_ch] = _i
    _CODE[_ch + 32] = _i  # lower case


@dataclasses.dataclass
class Index:
    """An SE index: EUMA of every segment for one read length."""

    names: List[str]
    readlength: int  # the SE read length (the file's header says -1)
    single: np.ndarray  # int64 [ntid]
    sig_offsets: np.ndarray  # int64 [n_multi + 1]
    sig_tids: np.ndarray  # int64 flat
    multi: np.ndarray  # int64 [n_multi]

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            np.savez(fh, names=np.array(self.names),
                     readlength=self.readlength, single=self.single,
                     sig_offsets=self.sig_offsets, sig_tids=self.sig_tids,
                     multi=self.multi)

    @staticmethod
    def load(path: str) -> "Index":
        with np.load(path) as z:
            return Index(names=[str(n) for n in z["names"]],
                         readlength=int(z["readlength"]),
                         single=z["single"], sig_offsets=z["sig_offsets"],
                         sig_tids=z["sig_tids"], multi=z["multi"])

    def rsh_text(self) -> bytes:
        """The ``.rsh`` text format of the reference builder (print_rsh)."""
        ntid = len(self.names)
        sizes = np.diff(self.sig_offsets)
        max_t = max(10, int(sizes.max(initial=0)))
        rl = self.readlength
        out = [f"#{ntid - 1},{max_t},{rl},{rl},-1\n"]
        out += [f"@{j}\t{n}\n" for j, n in enumerate(self.names)]
        out.append("cid\tno.tids\tfirst.tid\tother.tids\tsegment.length\n")
        single = self.single.tolist()
        out += [f"{j}\t1\t{j}\t\t{e},\n" if e else f"{j}\t1\t{j}\t\t\t\n"
                for j, e in enumerate(single)]
        tids = self.sig_tids.tolist()
        off = self.sig_offsets.tolist()
        multi = self.multi.tolist()
        for r in range(len(multi)):
            t = tids[off[r]:off[r + 1]]
            others = "".join(f"{x}," for x in t[1:])
            out.append(f"{ntid + r}\t{len(t)}\t{t[0]}\t{others}\t"
                       f"{multi[r]},\n")
        return "".join(out).encode()


def lexsort_rows(cols: List[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows lexicographically by ``cols``
    (first column most significant): stable sorts from the last column."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        order = order[torch.sort(c[order], stable=True).indices]
    return order


def _new_rows(cols: List[torch.Tensor]) -> torch.Tensor:
    """True where a sorted row differs from the one before it."""
    n = cols[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    if n:
        new[0] = True
    for c in cols:
        new[1:] |= c[1:] != c[:-1]
    return new


def _kmer_words(codes: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [n]: the WORD bases from each position packed 2 bits a base,
    first base highest."""
    w = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for i in range(WORD):
        w = w * 4 + codes[i:i + n]
    return w


def window_keys(codes: torch.Tensor, pos: torch.Tensor, rl: int,
                unstranded: bool) -> List[torch.Tensor]:
    """Key words of the windows starting at ``pos`` of the forward strand
    ``codes`` (values 0-3, padded by at least ``rl + WORD`` bases)."""
    L = codes.shape[0] - rl - WORD  # forward length before the padding
    n_words = -(-rl // WORD)
    last = rl - WORD * (n_words - 1)
    fw = _kmer_words(codes, L + rl)
    words = [fw[pos + WORD * j] for j in range(n_words)]
    words[-1] = words[-1] >> (2 * (WORD - last))
    if not unstranded:
        return words
    rc_codes = torch.cat([(3 - codes[:L]).flip(0), codes[L:]])
    rc = _kmer_words(rc_codes, L + rl)
    q = L - pos - rl  # the reverse complement's start on the rc strand
    rwords = [rc[q + WORD * j] for j in range(n_words)]
    rwords[-1] = rwords[-1] >> (2 * (WORD - last))
    less = torch.zeros_like(pos, dtype=torch.bool)
    decided = torch.zeros_like(less)
    for a, b in zip(words, rwords):
        less |= ~decided & (b < a)
        decided |= a != b
    return [torch.where(less, b, a) for a, b in zip(words, rwords)]


def build(seqs: List[bytes], names: List[str], rl: int, device,
          unstranded: bool = True, max_repeat: int = 100,
          key_bits: Optional[int] = None) -> Index:
    """The SE index of ``seqs`` for read length ``rl``."""
    ntid = len(seqs)
    fw = _CODE[np.frombuffer(b"@".join(seqs), dtype=np.uint8)]
    L = fw.shape[0]
    starts = np.zeros(ntid, dtype=np.int64)
    np.cumsum([len(s) + 1 for s in seqs[:-1]], out=starts[1:])
    codes = torch.from_numpy(np.concatenate(
        [fw, np.full(rl + WORD, 4, np.uint8)])).to(device)
    bad = torch.cumsum((codes >= 4).to(torch.int32), 0)
    bad = torch.cat([torch.zeros(1, dtype=torch.int32, device=device), bad])
    n_win = max(L - rl + 1, 0)
    pos = torch.arange(n_win, device=device)
    pos = pos[bad[pos + rl] == bad[pos]]
    del bad
    codes = codes.masked_fill(codes >= 4, 0).to(torch.int64)
    words = window_keys(codes, pos, rl, unstranded)
    del codes
    if key_bits is not None:
        h = torch.zeros_like(words[0])
        for w in words:
            h = h * 0x27D4EB2F165667C5 + w  # wraps modulo 2**64
        words = [(h ^ (h >> 29)) & ((1 << key_bits) - 1)]
    order = lexsort_rows(words)
    words = [w[order] for w in words]
    pos = pos[order]
    run = torch.cumsum(_new_rows(words).to(torch.int64), 0) - 1
    del words, order
    tid = torch.searchsorted(torch.from_numpy(starts).to(device), pos,
                             right=True) - 1
    del pos
    n_runs = int(run[-1]) + 1 if run.numel() else 0
    length = torch.bincount(run, minlength=n_runs)
    win_len = length[run]
    single = torch.bincount(tid[win_len == 1], minlength=ntid)

    # multi runs: their windows' transcripts, sorted within each run
    m = (win_len > 1) & (win_len < max_repeat)
    run_m, tid_m, len_m = run[m], tid[m], win_len[m]
    o = lexsort_rows([run_m, tid_m])
    run_m, tid_m, len_m = run_m[o], tid_m[o], len_m[o]
    first = _new_rows([run_m])
    sigs, counts = [], []
    for s in torch.unique(len_m).tolist():
        at = torch.nonzero(first & (len_m == s)).squeeze(1)
        rows = tid_m[at[:, None] + torch.arange(s, device=device)]
        cols = [rows[:, k] for k in range(s)]
        o = lexsort_rows(cols)
        rows = rows[o]
        new = _new_rows([rows[:, k] for k in range(s)])
        gid = torch.cumsum(new.to(torch.int64), 0) - 1
        sigs.append(rows[new].cpu().numpy())
        counts.append(torch.bincount(gid).cpu().numpy())
    sizes = np.concatenate([np.full(len(c), r.shape[1]) for r, c in
                            zip(sigs, counts)]) if sigs else np.zeros(0)
    offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return Index(names=list(names), readlength=rl,
                 single=single.cpu().numpy().astype(np.int64),
                 sig_offsets=offsets,
                 sig_tids=(np.concatenate([r.ravel() for r in sigs])
                           if sigs else np.zeros(0, np.int64)),
                 multi=(np.concatenate(counts) if counts
                        else np.zeros(0, np.int64)).astype(np.int64))
