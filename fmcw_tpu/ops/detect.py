"""Detection extraction (JAX) — fixed-capacity top-K with validity mask.

The reference zero-suppresses the CFAR stream and forwards up to 64
detections per scan in stream order (rtl/src/radar_core.vhd:413-418,
tws_tracker.vhd:66-76).  Variable-length outputs don't exist under jit, so
the framework extracts the K strongest detections into fixed arrays with a
validity mask — strictly better under overload (docs/design_notes.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("max_dets",))
def topk_detections(det_map: jnp.ndarray, max_dets: int = 64):
    """Extract the ``max_dets`` strongest nonzero cells of a (R, D) detection
    map.  Returns dict with range_bin, doppler_bin (int32), mag (map dtype),
    valid (bool) — all length ``max_dets`` — and n_dets (total nonzero count,
    may exceed max_dets; the overflow analog of the 64-det buffer cap).

    Large maps use an exact row-select reduction: per-row max (a cheap lane
    reduce), top-k over the R row maxes to pick ``max_dets`` candidate rows,
    then a flat top-k over just those rows' cells.  This is ~8x less top_k
    work than a per-row top-k + flat pass and provably identical to the
    single flat top_k *including ties*: every row holding a global top-k
    cell has row-max >= the k-th value; rows tied exactly at the k-th value
    are taken lowest-index-first by lax.top_k, and the rows containing the
    flat top_k's consumed tie cells are precisely a prefix of those
    ascending tie rows (each row with max above the k-th value holds at
    least one consumed cell, so the tie-row slots never run out).
    Re-sorting the selected rows ascending makes the gathered layout
    (row, col)-lexicographic, so the final top_k's tie order matches the
    flat one exactly."""
    R, D = det_map.shape
    if R * D > 16384 and R >= max_dets:
        _, rows = jax.lax.top_k(jnp.max(det_map, axis=1), max_dets)
        rows = jnp.sort(rows)                             # ascending row ids
        sub = jnp.take(det_map, rows, axis=0)             # (max_dets, D)
        vals, i2 = jax.lax.top_k(sub.ravel(), max_dets)
        range_bin = jnp.take(rows, i2 // D).astype(jnp.int32)
        doppler_bin = (i2 % D).astype(jnp.int32)
    else:
        vals, idx = jax.lax.top_k(det_map.ravel(), max_dets)
        range_bin = (idx // D).astype(jnp.int32)
        doppler_bin = (idx % D).astype(jnp.int32)
    valid = vals > 0
    n_dets = jnp.sum(det_map > 0)
    return {
        "range_bin": range_bin,
        "doppler_bin": doppler_bin,
        "mag": vals,
        "valid": valid,
        "n_dets": n_dets.astype(jnp.int32),
    }
