"""Agreement criterion between a SQUAREM block and its plain version.

Shared by the CPU tests (plain version against the Pallas kernel in
interpret mode) and the on-card check in ``chip_smoke.py`` (CUDA kernel
against the plain version on the card).

Tolerances are relative to each module's largest theta (``block_tol``).
One cycle isolates the arithmetic: the CUDA kernel and the plain version
differed by <= 6e-7 in float32 and <= 1e-15 in float64 on the H100.  Over
a block of 8 cycles SQUAREM's alpha^2 extrapolation amplifies rounding
about tenfold per doubling of the cycle count: up to 1.4e-3 (float32) and
1.3e-12 (float64) between kernel and plain on the H100, <= 7e-4 / 2e-12
between XLA and torch on the CPU; each float32 version alone lay 1e-4 to
1e-3 from a float64 evaluation of the same inputs.  Only modules whose
every accept test had |gain| above ``ACCEPT_MARGIN`` of its terms'
magnitude are compared: nearer the ``gain >= 0`` boundary another order
may flip the decision.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .squarem import squarem_cycle_ref

ACCEPT_MARGIN = {torch.float64: 1e-8, torch.float32: 1e-4}


def block_tol(dtype: torch.dtype, n_iters: int) -> float:
    """Agreement bound after ``n_iters`` cycles (see the module note)."""
    if n_iters <= 1:
        return {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    return {torch.float64: 1e-9, torch.float32: 5e-3}[dtype]


def random_modules(rng: np.random.Generator, B: int, C: int, T: int,
                   dtype=np.float64) -> Tuple[np.ndarray, ...]:
    """B random padded modules of class (C, T): memberships of 0, 1 or 2
    with every segment in at least one transcript, Poisson reads, and the
    read-attribution start.  Returns (m, eumaps, reads, inv_denom, theta0)
    as NumPy arrays of ``dtype``."""
    m = (rng.random((B, C, T)) < 3.0 / T).astype(dtype)
    m[:, np.arange(C), rng.integers(0, T, size=C)] += 1.0
    e = rng.uniform(0.01, 2.0, size=(B, C)).astype(dtype)
    r = rng.poisson(30 * e).astype(dtype)
    denom = np.einsum("bct,bc->bt", m, e)
    inv = np.where(denom > 0, 1 / np.where(denom > 0, denom, 1), 0)
    theta0 = np.einsum("bct,bc->bt", m, r) * inv
    return m, e, r, inv.astype(dtype), theta0.astype(dtype)


def accept_margin_ref(m, eumaps, reads, inv_denom, theta, n_iters: int,
                      skip_unread: bool = False) -> torch.Tensor:
    """Per module, the smallest |gain| / gain_scale over the accept tests
    of ``n_iters`` plain-version cycles from ``theta`` (``skip_unread``:
    the gain's form, ``squarem_cycle_ref``'s)."""
    margin = torch.full((theta.shape[0],), float("inf"), dtype=theta.dtype,
                        device=theta.device)
    for _ in range(n_iters):
        theta, gain, scale = squarem_cycle_ref(m, eumaps, reads, inv_denom,
                                               theta, skip_unread)
        rel = gain.abs() / torch.where(scale > 0, scale, 1.0)
        margin = torch.minimum(margin, torch.where(scale > 0, rel, margin))
    return margin


def block_agreement(got: torch.Tensor, want: torch.Tensor, m, eumaps,
                    reads, inv_denom, theta0, n_iters: int,
                    skip_unread: bool = False) -> Tuple[float, float, int]:
    """Agreement of two ``n_iters``-cycle results from ``theta0`` (``want``
    the plain version's, both with the gain ``skip_unread`` selects) over
    the modules away from the accept boundary: (largest per-module
    max|got - want| / max|want|, largest |got - want|, number of such
    modules)."""
    margin = accept_margin_ref(m, eumaps, reads, inv_denom, theta0, n_iters,
                               skip_unread)
    decisive = margin > ACCEPT_MARGIN[theta0.dtype]
    if not decisive.any():
        return 0.0, 0.0, 0
    diff = (got - want).abs()[decisive]
    scale = want.abs()[decisive].amax(dim=1)
    rel = diff.amax(dim=1) / torch.where(scale > 0, scale, 1.0)
    return float(rel.max()), float(diff.max()), int(decisive.sum())
