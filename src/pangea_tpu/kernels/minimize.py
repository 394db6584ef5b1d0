"""On-device disjoint-window minimizer selection (SEMANTICS.md §3 v4).

The sampling move: the classify step was bound by the COUNT of table-row
gathers (chosen on the earlier accelerator; unmeasured on the H100), so
w > 1 shrinks the probe tensor itself from [B, P] to [B, ceil(P/w)] via an
elementwise tournament — trading cheap elementwise ops for gathers. Index-side (overlapping-window, build-time)
selection stays on the host in core.semantics_np.minimizer_mask.

Bit-exactness contract: identical to `core.disjoint_query_minimizers`
(tested in tests/test_device_parity.py).
"""
from __future__ import annotations

import jax.numpy as jnp

from .lookup import hash32_jnp


def select_minimizers_jnp(hi, lo, valid, w: int):
    """hi/lo/valid: uint32/bool [B, P] → (hi_m, lo_m, wvalid) [B, NW]
    with NW = floor(P/w) (full windows only — SEMANTICS.md §3): per valid
    disjoint window, the hash32-argmin position's k-mer (ties → leftmost).
    Invalid windows yield wvalid False (their hi/lo outputs are
    unspecified and must be masked by lookup)."""
    B, P = hi.shape
    NW = P // w
    if NW == 0:
        raise ValueError(f"read positions {P} shorter than window {w}")
    h = hash32_jnp(hi, lo)[:, :NW * w]
    hw = h.reshape(B, NW, w)
    hiw = hi[:, :NW * w].reshape(B, NW, w)
    low = lo[:, :NW * w].reshape(B, NW, w)
    valid = valid[:, :NW * w]
    wvalid = valid.reshape(B, NW, w).all(axis=-1)
    # Leftmost-argmin tournament: strict < keeps the earliest minimum.
    best_h = hw[..., 0]
    best_hi = hiw[..., 0]
    best_lo = low[..., 0]
    for j in range(1, w):
        better = hw[..., j] < best_h
        best_h = jnp.where(better, hw[..., j], best_h)
        best_hi = jnp.where(better, hiw[..., j], best_hi)
        best_lo = jnp.where(better, low[..., j], best_lo)
    return best_hi, best_lo, wvalid
