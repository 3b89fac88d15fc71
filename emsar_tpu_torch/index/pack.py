"""2-bit sequence packing and window sort keys.

A read-length window is represented as ``W = ceil(readlength/16)`` uint32
words of 2-bit base codes (A=0 C=1 G=2 T=3, big-endian within the word), so

* word-wise lexicographic comparison of two windows == ``strncmp`` of the
  underlying strings (reference comparisons: strdiff_se/strcmp_pe,
  src/emsar_functions.c:2663-2686), and
* ``jax.lax.sort`` over the word columns is the TPU replacement for the
  reference's strncmp quicksort (quick_sort_suffixarray_4,
  src/emsar_functions.c:1108-1149).

The rolling pack array P16 (packed 16-mer starting at every position) is
built once per transcriptome in O(16·L); window keys are then pure gathers.
"""

from __future__ import annotations

import numpy as np

WORD_BASES = 16  # bases per uint32 word


def n_words(readlength: int) -> int:
    return (readlength + WORD_BASES - 1) // WORD_BASES


def pack16(codes: np.ndarray) -> np.ndarray:
    """P16[i] = the 16 bases starting at i, 2 bits each, big-endian.

    Out-of-range / non-ACGT positions contribute arbitrary (masked-to-0)
    bits; callers must only use keys of fully canonical windows.
    """
    L = codes.shape[0]
    p = np.zeros(L, dtype=np.uint32)
    c = (codes & 3).astype(np.uint32)
    for j in range(WORD_BASES):
        shift = 2 * (WORD_BASES - 1 - j)
        if j == 0:
            p |= c << np.uint32(shift)
        else:
            p[:-j] |= c[j:] << np.uint32(shift)
    return p


def bad_prefix(codes: np.ndarray) -> np.ndarray:
    """bad_prefix[i] = number of non-ACGT chars in codes[:i] (len L+1)."""
    bad = (codes >= 4).astype(np.int32)
    out = np.zeros(codes.shape[0] + 1, dtype=np.int32)
    np.cumsum(bad, out=out[1:])
    return out


def valid_windows(bad_pref: np.ndarray, positions: np.ndarray, readlength: int) -> np.ndarray:
    """True where the window [p, p+readlength) is all-ACGT."""
    positions = np.asarray(positions, dtype=np.int64)
    return bad_pref[positions + readlength] - bad_pref[positions] == 0


def window_words_np(p16: np.ndarray, positions: np.ndarray, readlength: int) -> np.ndarray:
    """Gather the [N, W] uint32 key matrix for window starts (NumPy path)."""
    positions = np.asarray(positions, dtype=np.int64)
    W = n_words(readlength)
    out = np.empty((positions.shape[0], W), dtype=np.uint32)
    for w in range(W):
        out[:, w] = p16[positions + WORD_BASES * w]
    rem = readlength - WORD_BASES * (W - 1)
    if rem < WORD_BASES:
        # drop the trailing bases of the last word; right shift preserves order
        out[:, W - 1] >>= np.uint32(2 * (WORD_BASES - rem))
    return out


def lexmin_words_np(a: np.ndarray, b: np.ndarray):
    """Row-wise lexicographic comparison of two [N, W] word matrices.

    Returns (cmp, minwords): cmp in {-1,0,1} per row (a vs b), and the
    row-wise lexicographic minimum.
    """
    cmp = np.zeros(a.shape[0], dtype=np.int8)
    for w in range(a.shape[1]):
        c = (a[:, w] > b[:, w]).astype(np.int8) - (a[:, w] < b[:, w]).astype(np.int8)
        cmp = np.where(cmp == 0, c, cmp)
    minwords = np.where((cmp <= 0)[:, None], a, b)
    return cmp, minwords


def lexcmp_words_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic cmp in {-1,0,1} of two [N, W] word matrices."""
    cmp = np.zeros(a.shape[0], dtype=np.int8)
    for w in range(a.shape[1]):
        c = (a[:, w] > b[:, w]).astype(np.int8) - (a[:, w] < b[:, w]).astype(np.int8)
        cmp = np.where(cmp == 0, c, cmp)
    return cmp
