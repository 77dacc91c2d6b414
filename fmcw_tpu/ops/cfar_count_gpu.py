"""Counting OS-CFAR on the GPU: one Pallas kernel (Triton route).

ops/cfar.cfar_2d_count decides ``CUT > est*scale`` by counting, for each
cell, the training cells that reach a per-cell threshold.  In plain jnp XLA
builds the 128 shifted compares as multi-output fusions whose boolean
results it writes out, one (R, D) plane per training offset, before an add
fusion sums them: 128 planes of predicates per counting pass.  This kernel
keeps the counting in registers instead: each program owns a (TR, TD) tile
of cells, reads the tile's shifted window from the padded map once per
training offset (L1/L2-resident: neighbouring offsets overlap), and
accumulates every requested count before one store per count.

The thresholds and the decision that consumes the counts stay in jnp
(ops/cfar.cfar_2d_count), so the kernel is arithmetic-free beyond compares
and adds, and its results are exact integer counts in both modes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _count_kernel(p_ref, *refs, offsets, strict, hr, hd, R, D, TR, TD):
    n = len(strict)
    t_refs, c_refs = refs[:n], refs[n:]
    r0 = pl.program_id(0) * TR
    c0 = pl.program_id(1) * TD
    rows = r0 + jnp.arange(TR)
    cols = c0 + jnp.arange(TD)
    mask = (rows < R)[:, None] & (cols < D)[None, :]
    tile = (pl.ds(r0, TR), pl.ds(c0, TD))
    thr = [plgpu.load(t.at[tile], mask=mask, other=0) for t in t_refs]
    cnt = [jnp.zeros((TR, TD), jnp.int32) for _ in range(n)]
    for dr, dd in offsets:
        v = plgpu.load(p_ref.at[pl.ds(r0 + hr + dr, TR),
                                pl.ds(c0 + hd + dd, TD)],
                       mask=mask, other=0)
        for j in range(n):
            hit = (v > thr[j]) if strict[j] else (v >= thr[j])
            cnt[j] = cnt[j] + hit.astype(jnp.int32)
    for c_ref, c in zip(c_refs, cnt):
        plgpu.store(c_ref.at[tile], c, mask=mask)


@functools.partial(jax.jit, static_argnames=("offsets", "strict", "hr", "hd",
                                             "interpret"))
def count_window(padded: jnp.ndarray, thresholds: tuple, offsets: tuple,
                 strict: tuple, hr: int, hd: int, interpret: bool = False):
    """``counts[j][r, d] = #{(dr, dd) in offsets: v OP_j thresholds[j][r, d]}``
    with ``v = padded[hr + r + dr, hd + d + dd]`` and OP_j ``>`` where
    ``strict[j]`` else ``>=``.  ``padded`` is the map padded by (hr, hd) on
    each side; thresholds are (R, D) in its dtype.  Returns a tuple of int32
    (R, D) counts.  ``interpret=True`` runs the Pallas interpreter (CPU
    tests); on the GPU it compiles through Triton."""
    R, D = thresholds[0].shape
    TD = min(128, _next_pow2(D))
    TR = 8
    kernel = functools.partial(_count_kernel, offsets=offsets, strict=strict,
                               hr=hr, hd=hd, R=R, D=D, TR=TR, TD=TD)
    return tuple(pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((R, D), jnp.int32)] * len(strict),
        grid=(pl.cdiv(R, TR), pl.cdiv(D, TD)),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="cfar_count_window",
    )(padded, *thresholds))
