"""2D CFAR detection (JAX).

Array reformulation of rtl/src/os_cfar_2d.vhd.  The reference streams one
cell per clock through a line buffer + 2D shift register and bubble-sorts the
128 training cells per cell (the design's computational hot spot, SURVEY.md
CS-1).  Here the whole (n_range, n_doppler) map is processed at once, by one
of two OS formulations (``cfar_route`` picks one):

* ``"count"`` (cfar_2d_count): the decision by counting.  For the k-th
  largest training value est, ``CUT > est*scale`` holds exactly when fewer
  than k training cells reach ``CUT/scale``, so each of the ``n_ref``
  shifted views of the padded map is compared once per cell and never
  stacked.  No threshold tap.
* ``"topk"`` (cfar_2d): the ``n_ref`` shifted views stacked on a trailing
  axis and ranked with ``lax.top_k`` (the rank_idx-th ascending order
  statistic is the (n_ref - rank_idx)-th largest).  The reference for the
  counting route and the source of the dbg_threshold tap.

Window sums for the adaptive-scale mean and the CA/GO/SO variants use
separable box sums (two 1D passes), never materializing per-cell windows.
All variants share the adaptive threshold scaling of os_cfar_2d.vhd:187-199
and the runtime scale_override control port.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..params import CfarParams
from ..golden.fixed_point import _window_offsets, _hw_stream_offsets, \
    hw_stream_lag


def _pad2d(m: jnp.ndarray, hr: int, hd: int, edge_mode: str,
           prepadded_range: bool = False) -> jnp.ndarray:
    """Pad the map by the window halo.  With ``prepadded_range`` the caller
    already supplied ``hr`` extra rows on each side (e.g. a cross-shard halo
    exchange — parallel/sharded.py) and only the Doppler axis is padded."""
    if prepadded_range:
        return jnp.pad(m, ((0, 0), (hd, hd)), mode=edge_mode)
    if edge_mode in ("wrap", "reflect"):
        return jnp.pad(m, ((hr, hr), (hd, hd)), mode=edge_mode)
    raise ValueError(edge_mode)


def _box1d(p: jnp.ndarray, win: int, axis: int) -> jnp.ndarray:
    """Sum over a length-``win`` sliding window along ``axis`` of an array
    already padded by the half-window on each side; output has the unpadded
    extent.  Unrolled as ``win`` shifted slices — XLA fuses them."""
    out_len = p.shape[axis] - win + 1
    sl = [slice(None)] * p.ndim
    acc = None
    for k in range(win):
        sl[axis] = slice(k, k + out_len)
        piece = p[tuple(sl)]
        acc = piece if acc is None else acc + piece
    return acc


def _box2d_sum(padded: jnp.ndarray, win_r: int, win_d: int) -> jnp.ndarray:
    return _box1d(_box1d(padded, win_r, 0), win_d, 1)


def _ref_stack(m: jnp.ndarray, cfar: CfarParams,
               prepadded_range: bool = False) -> jnp.ndarray:
    """(R, D, n_ref) stack of the training cells for every CUT."""
    hr, hd = cfar.halo_range, cfar.halo_doppler
    p = _pad2d(m, hr, hd, cfar.edge_mode, prepadded_range)
    R = m.shape[0] - 2 * hr if prepadded_range else m.shape[0]
    D = m.shape[1]
    views = [jax.lax.dynamic_slice(p, (hr + dr, hd + dd), (R, D))
             for dr, dd in _window_offsets(cfar)]
    return jnp.stack(views, axis=-1)


def _ref_sums(m: jnp.ndarray, cfar: CfarParams, prepadded_range: bool = False):
    """(sum_refs, sum_lead, sum_lag): training-cell sums via separable box
    sums — full window minus guard window; lead/lag are the half-windows on
    the low/high range side of the CUT (for GO/SO)."""
    hr, hd = cfar.halo_range, cfar.halo_doppler
    p = _pad2d(m, hr, hd, cfar.edge_mode, prepadded_range)
    full = _box2d_sum(p, cfar.win_range, cfar.win_doppler)
    gr, gd = cfar.guard_range, cfar.guard_doppler
    pg = p[hr - gr: p.shape[0] - (hr - gr), hd - gd: p.shape[1] - (hd - gd)]
    guard = _box2d_sum(pg, 2 * gr + 1, 2 * gd + 1)
    sum_refs = full - guard

    # Lead/lag half windows along range: rows [-hr, -gr-1] and [gr+1, hr].
    n_half = cfar.ref_range * cfar.win_doppler
    cols = _box1d(p, cfar.win_doppler, 1)  # (R + 2*hr, D)
    R = m.shape[0] - 2 * hr if prepadded_range else m.shape[0]
    lead = _box1d(cols[: R + hr - gr - 1], cfar.ref_range, 0)[:R]
    lag = _box1d(cols[hr + gr + 1:], cfar.ref_range, 0)[:R]
    return sum_refs, lead, lag, n_half


def block_scale_map(mag_map: jnp.ndarray, cfar: CfarParams,
                    integer: bool) -> jnp.ndarray:
    """Block-granular ("clutter-map") adaptive scale, int32 (R, D).

    JAX mirror of golden.fixed_point.block_scale_map (see there and
    CfarParams.scale_mode for the semantics); float mode uses true division
    and 1.5x/0.5x factors like the per-cell float path.  The detection
    then skips its per-cell mean + hi/lo classification passes entirely.

      * block grids live transposed (Db, Rb), reduced by reshape-sums;
      * the hi and lo indicators are **packed into one integer**
        (ind_hi + ind_lo << 12) so one reduce chain serves both counts;
        12-bit fields hold counts up to 9*B^2 = 3969 neighborhood cells
        (B <= 21, validated below) with no carry between fields;
      * block->cell broadcasts are jnp.repeat (fuses into the consuming
        compare).

    All arithmetic is exact in both modes: integer throughout for
    ``integer=True``, and for float every reduction is a straight f32 sum
    (same association order as the golden model's axis reductions).
    """
    B = cfar.scale_block
    R, D = mag_map.shape
    if R % B or D % B:
        raise ValueError(f"scale_block={B} must divide map shape {(R, D)}")
    if 9 * B * B > 4095:
        raise ValueError(
            f"scale_block={B}: 9*B^2 = {9 * B * B} neighborhood cells "
            f"overflow the 12-bit packed hi/lo count fields (B <= 21)")
    Rb, Db = R // B, D // B
    N = 9 * B * B
    rank_idx = min((N * cfar.rank_pct) // 100, N - 1)
    k = N - rank_idx
    m = mag_map.astype(jnp.int32) if integer else mag_map.astype(jnp.float32)

    def shift(a, i, j):
        """grid[b] <- grid[b + (i, j)]; a is any-orientation block grid —
        only the symmetric 3x3 sum uses it, so axis order is irrelevant."""
        if cfar.edge_mode == "wrap":
            return jnp.roll(a, (-i, -j), axis=(0, 1))
        ri = jnp.clip(jnp.arange(a.shape[0]) + i, 0, a.shape[0] - 1)
        rj = jnp.clip(jnp.arange(a.shape[1]) + j, 0, a.shape[1] - 1)
        return jnp.take(jnp.take(a, ri, axis=0), rj, axis=1)

    def nb9(a):
        return sum(shift(a, i, j) for i in (-1, 0, 1) for j in (-1, 0, 1))

    def block_reduce_t(x):
        """(R, D) -> transposed (Db, Rb) per-block sums."""
        rows = x.reshape(Rb, B, D).sum(axis=1)        # (Rb, D)
        return rows.T.reshape(Db, B, Rb).sum(axis=1)  # (Db, Rb)

    def to_cells(tb_t):
        """transposed (Db, Rb) block grid -> (R, D) cells."""
        return jnp.repeat(jnp.repeat(tb_t, B, axis=0).T, B, axis=0)

    if integer:
        mean = to_cells(nb9(block_reduce_t(m)) // N)  # block-constant int32
        ind = ((m > mean + (mean >> 1)).astype(jnp.int32)
               + ((m >= (mean >> 1)).astype(jnp.int32) << 12))
    else:
        mean = to_cells(nb9(block_reduce_t(m)) / N)
        ind = ((m > 1.5 * mean).astype(jnp.int32)
               + ((m >= 0.5 * mean).astype(jnp.int32) << 12))
    packed = nb9(block_reduce_t(ind))                 # (Db, Rb)
    cnt_hi = packed & 4095
    cnt_lo = packed >> 12
    scale_b = jnp.where(cnt_hi >= k, cfar.scale_max,
                        jnp.where(cnt_lo < k, cfar.scale_min, cfar.scale_nom))
    return to_cells(scale_b).astype(jnp.int32)


def block_scale_map_sharded(mag_local: jnp.ndarray, cfar: CfarParams,
                            integer: bool, axis_name: str) -> jnp.ndarray:
    """Range-sharded block_scale_map: each shard holds a contiguous
    (R_local, D) slab of the map (D complete).  The 3x3-block neighborhood
    needs one *block-grid* row from each range neighbor — a ring ppermute of
    a (Db,)-sized row of block sums / packed counts (tiny: bytes, not map
    rows), after which every per-block quantity equals the single-chip
    value exactly (integer mode bit-exact; float mode adds in the same
    (i, j) order as the single-chip nb9).  edge_mode='wrap' realizes the
    global torus through the ring; edge_mode='reflect' matches the
    single-chip shift's CLIP semantics — edge shards substitute their own
    edge block column for the out-of-range neighbor, and the Doppler-block
    axis clips locally.
    """
    B = cfar.scale_block
    R, D = mag_local.shape
    if R % B or D % B:
        raise ValueError(f"scale_block={B} must divide local shape {(R, D)}")
    if 9 * B * B > 4095:
        raise ValueError(
            f"scale_block={B}: 9*B^2 = {9 * B * B} neighborhood cells "
            f"overflow the 12-bit packed hi/lo count fields (B <= 21)")
    clip = cfar.edge_mode != "wrap"
    Rb, Db = R // B, D // B
    N = 9 * B * B
    rank_idx = min((N * cfar.rank_pct) // 100, N - 1)
    k = N - rank_idx
    m = mag_local.astype(jnp.int32) if integer else mag_local.astype(jnp.float32)

    n_sh = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n_sh) for i in range(n_sh)]
    bwd = [(i, (i - 1) % n_sh) for i in range(n_sh)]

    def ext_range(grid):
        """(Db, Rb) -> (Db, Rb + 2): ring halo along the range-block axis;
        clip mode substitutes the shard's own edge column at global edges."""
        left = jax.lax.ppermute(grid[:, -1:], axis_name, fwd)
        right = jax.lax.ppermute(grid[:, :1], axis_name, bwd)
        if clip:
            idx = jax.lax.axis_index(axis_name)
            left = jnp.where(idx == 0, grid[:, :1], left)
            right = jnp.where(idx == n_sh - 1, grid[:, -1:], right)
        return jnp.concatenate([left, grid, right], axis=1)

    def nb9(grid):
        """Same term order as block_scale_map's nb9 (axis0=Doppler blocks
        gets offset i, axis1=range blocks offset j) for float parity."""
        e = ext_range(grid)
        di = jnp.arange(Db)
        out = None
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                col = e[:, 1 + j: 1 + j + Rb]
                t = (jnp.take(col, jnp.clip(di + i, 0, Db - 1), axis=0)
                     if clip else jnp.roll(col, -i, axis=0))
                out = t if out is None else out + t
        return out

    def block_reduce_t(x):
        rows = x.reshape(Rb, B, D).sum(axis=1)
        return rows.T.reshape(Db, B, Rb).sum(axis=1)

    def to_cells(tb_t):
        return jnp.repeat(jnp.repeat(tb_t, B, axis=0).T, B, axis=0)

    if integer:
        mean = to_cells(nb9(block_reduce_t(m)) // N)
        ind = ((m > mean + (mean >> 1)).astype(jnp.int32)
               + ((m >= (mean >> 1)).astype(jnp.int32) << 12))
    else:
        mean = to_cells(nb9(block_reduce_t(m)) / N)
        ind = ((m > 1.5 * mean).astype(jnp.int32)
               + ((m >= 0.5 * mean).astype(jnp.int32) << 12))
    packed = nb9(block_reduce_t(ind))
    cnt_hi = packed & 4095
    cnt_lo = packed >> 12
    scale_b = jnp.where(cnt_hi >= k, cfar.scale_max,
                        jnp.where(cnt_lo < k, cfar.scale_min, cfar.scale_nom))
    return to_cells(scale_b).astype(jnp.int32)


def _order_statistic(refs: jnp.ndarray, rank_idx: int) -> jnp.ndarray:
    """rank_idx-th ascending order statistic over the trailing axis via
    top_k of the (n_ref - rank_idx) largest (os_cfar_2d.vhd:172-183)."""
    n_ref = refs.shape[-1]
    k = n_ref - rank_idx
    top, _ = jax.lax.top_k(refs, k)
    return top[..., k - 1]


CFAR_ROUTES = ("count", "topk")


def cfar_route(cfar: CfarParams, method: str = "auto",
               need_debug: bool = True) -> str:
    """The 2D decision route for ``method``: "count" (cfar_2d_count) or
    "topk" (cfar_2d — the ranked stack for OS, box sums for CA/GO/SO).

    "auto" counts for the OS variant when the threshold tap is unused and
    takes cfar_2d otherwise.  A removed or unknown route raises; nothing
    falls back silently."""
    if method == "auto":
        return "count" if cfar.variant == "os" and not need_debug else "topk"
    if method not in CFAR_ROUTES:
        raise ValueError(f"cfar method {method!r} has no compiled route; "
                         f"choose 'auto' or one of {CFAR_ROUTES}")
    if method == "count":
        if cfar.variant != "os":
            raise ValueError("the counting CFAR decides the os variant only; "
                             "ca/go/so take method='topk' (box sums)")
        if need_debug:
            raise ValueError("the counting CFAR computes no threshold tap; "
                             "pass need_debug=False or method='topk'")
    return method


def cfar_2d_auto(mag_map: jnp.ndarray, scale_override: jnp.ndarray | int = 0,
                 cfar: CfarParams = CfarParams(), integer: bool = False,
                 prepadded_range: bool = False, method: str = "auto",
                 need_debug: bool = True,
                 scale_map: jnp.ndarray | None = None):
    """CFAR over the route ``cfar_route(cfar, method, need_debug)`` names.
    Returns (det_map, threshold, scale) like cfar_2d; on the counting route
    ``threshold`` is None (only pass need_debug=False when the
    dbg_threshold tap is unused)."""
    if cfar_route(cfar, method, need_debug) == "count":
        det, scale = cfar_2d_count(mag_map, scale_override, cfar=cfar,
                                   integer=integer,
                                   prepadded_range=prepadded_range,
                                   scale_map=scale_map)
        return det, None, scale
    return cfar_2d(mag_map, scale_override, cfar=cfar, integer=integer,
                   prepadded_range=prepadded_range, scale_map=scale_map)


def _count_threshold(cut: jnp.ndarray, scale, integer: bool) -> jnp.ndarray:
    """The least training value q with ``q*scale >= cut``, per cell: then
    ``count(refs >= q) < k`` is exactly ``cut > est*scale`` for the k-th
    largest training value est, without ranking.

    Integer: the ceiling ``(cut + s - 1) // s``.  Float: v -> RN(v*s) is
    monotone, so the bound is one float, and it lies within 2 ulps below
    RN(cut/s); probing those candidates gives it exactly
    (tests/test_cfar_count.py::test_count_float_qmin_fuzz)."""
    if integer:
        s = jnp.maximum(jnp.asarray(scale, cut.dtype), 1)
        return (cut + s - 1) // s
    sf = jnp.asarray(scale, jnp.float32)
    bc = jax.lax.bitcast_convert_type
    ti = bc(cut / sf, jnp.int32)
    q = bc(ti + 1, jnp.float32)
    for delta in (0, -1, -2):
        c = bc(ti + delta, jnp.float32)
        q = jnp.where(c * sf >= cut, c, q)
    return q


def _scale_select(hi, lo, cfar: CfarParams, so) -> jnp.ndarray:
    """{scale_min, scale_nom, scale_max} from the clutter class, with the
    nonzero scale_override winning (os_cfar_2d.vhd:187-199)."""
    scale = jnp.where(hi, cfar.scale_max,
                      jnp.where(lo, cfar.scale_min, cfar.scale_nom))
    return jnp.where(so != 0, so, scale)


@functools.partial(jax.jit,
                   static_argnames=("cfar", "integer", "prepadded_range",
                                    "impl", "interpret"))
def cfar_2d_count(mag_map: jnp.ndarray, scale_override: jnp.ndarray | int = 0,
                  cfar: CfarParams = CfarParams(), integer: bool = False,
                  prepadded_range: bool = False,
                  scale_map: jnp.ndarray | None = None,
                  impl: str = "auto", interpret: bool = False):
    """OS-CFAR decision by counting (no training stack, no rank selection).

    For the k-th largest training value est (k = n_ref - rank_idx):

        est >  T  <=>  count(refs >  T) >= k
        est <  T  <=>  count(refs >= T) <  k
        cut > est*scale  <=>  count(refs >= q) < k   (q: _count_threshold)

    One counting pass over the n_ref shifted views of the padded map
    yields the two clutter-class counts and the decision count for each
    scale the class can pick.  Returns (det_map, scale): integer mode is
    bit-exact against cfar_2d; float mode is decision-equivalent (the
    adaptive-scale mean here is the _ref_sums box tree, cfar_2d's OS branch
    sums its stack — an ulp apart, which can flip a hi/lo class only on an
    exact-boundary input).  Arguments as cfar_2d; ``scale_map`` supplies the
    block-mode scale of a range-sharded map (block_scale_map_sharded).

    ``impl`` picks who counts: "kernel" the Pallas counting kernel of
    ops/cfar_count_gpu (Triton; ``interpret=True`` runs it on the CPU for
    tests), "jnp" shifted-slice compares that XLA fuses, "auto" the kernel
    where the program is lowered for CUDA and jnp elsewhere
    (lax.platform_dependent).  The counts, and so the results, are equal."""
    if cfar.variant != "os":
        raise ValueError("cfar_2d_count decides the os variant only; "
                         "use cfar_2d for ca/go/so")
    if impl not in ("auto", "jnp", "kernel"):
        raise ValueError(f"impl must be 'auto', 'jnp' or 'kernel', "
                         f"got {impl!r}")
    m = mag_map
    in_dtype = m.dtype
    if jnp.issubdtype(in_dtype, jnp.integer) and in_dtype.itemsize < 4:
        m = m.astype(jnp.int32)
    hr, hd = cfar.halo_range, cfar.halo_doppler
    p = _pad2d(m, hr, hd, cfar.edge_mode, prepadded_range)
    R = m.shape[0] - 2 * hr if prepadded_range else m.shape[0]
    D = m.shape[1]
    offsets = tuple(_window_offsets(cfar))

    def view(q, dr, dd):
        return q[hr + dr:hr + dr + R, hd + dd:hd + dd + D]

    def counts(thresholds, strict):
        def by_jnp(q, *ts):
            return tuple(
                sum(((view(q, dr, dd) > t) if st else (view(q, dr, dd) >= t))
                    .astype(jnp.int32) for dr, dd in offsets)
                for t, st in zip(ts, strict))

        def by_kernel(p, *ts):
            from .cfar_count_gpu import count_window
            return count_window(p, ts, offsets, tuple(strict), hr, hd,
                                interpret=interpret)

        if impl == "jnp":
            return by_jnp(p, *thresholds)
        if impl == "kernel":
            return by_kernel(p, *thresholds)
        return jax.lax.platform_dependent(p, *thresholds, cuda=by_kernel,
                                          default=by_jnp)

    cut = view(p, 0, 0)
    k = cfar.n_ref - cfar.rank_idx
    so = jnp.asarray(scale_override)
    if cfar.scale_mode == "block":
        if scale_map is not None:
            scale = scale_map.astype(jnp.int32)
        elif prepadded_range:
            raise ValueError(
                "scale_mode='block' with a prepadded (sharded) map needs "
                "the halo-exchanged scale_map from block_scale_map_sharded")
        else:
            scale = block_scale_map(cut, cfar, integer)
        scale = jnp.where(so != 0, so, scale)
        (n_ge,) = counts([_count_threshold(cut, scale, integer)], [False])
    else:
        sum_refs = _ref_sums(m, cfar, prepadded_range)[0]
        if integer:
            mean = sum_refs // cfar.n_ref
            t_hi, t_lo = mean + (mean >> 1), mean >> 1
        else:
            mean = sum_refs / cfar.n_ref
            t_hi, t_lo = 1.5 * mean, 0.5 * mean
        qs = [_count_threshold(cut, jnp.where(so != 0, so, s), integer)
              for s in (cfar.scale_min, cfar.scale_nom, cfar.scale_max)]
        c_hi, c_lo, n_lo, n_nom, n_hi = counts(
            [t_hi, t_lo] + qs, [True, False, False, False, False])
        hi, lo = c_hi >= k, c_lo < k
        scale = _scale_select(hi, lo, cfar, so)
        n_ge = jnp.where(hi, n_hi, jnp.where(lo, n_lo, n_nom))
    det = jnp.where((n_ge < k) & (cut > 0), cut, jnp.zeros_like(cut))
    return det.astype(in_dtype), scale.astype(m.dtype)


@functools.partial(jax.jit,
                   static_argnames=("cfar", "integer", "prepadded_range"))
def cfar_2d(mag_map: jnp.ndarray, scale_override: jnp.ndarray | int = 0,
            cfar: CfarParams = CfarParams(), integer: bool = False,
            prepadded_range: bool = False,
            scale_map: jnp.ndarray | None = None):
    """2D CFAR over a (n_range, n_doppler) magnitude map.

    Returns (det_map, threshold, scale): the zero-suppressed detection map
    (cell value where CUT > threshold else 0, os_cfar_2d.vhd:204-217) plus the
    dbg_threshold/dbg_scale debug taps (os_cfar_2d.vhd:219-220).

    ``scale_override`` is a traced runtime control (0 = auto, cf. the
    cfar_scale_ovr port radar_core.vhd:49).  ``integer=True`` reproduces the
    golden fixed-point arithmetic (truncating mean, integer threshold).

    ``prepadded_range=True``: the input already carries halo_range extra rows
    on each side (cross-shard halo exchange); outputs have the unpadded row
    count.

    Integer maps narrower than 32 bits are upcast internally: est*scale
    would otherwise wrap (e.g. int16 full-scale x scale 6) and silently
    corrupt decisions.  det_map returns in the input dtype (cut values
    fit); threshold/scale return int32 for narrow inputs.
    """
    m = mag_map
    in_dtype = m.dtype
    if jnp.issubdtype(in_dtype, jnp.integer) and in_dtype.itemsize < 4:
        m = m.astype(jnp.int32)
    so = jnp.asarray(scale_override)

    if cfar.variant == "os":
        refs = _ref_stack(m, cfar, prepadded_range)
        est = _order_statistic(refs, cfar.rank_idx)
        sum_refs = jnp.sum(refs, axis=-1)
    else:
        sum_refs, lead, lag, n_half = _ref_sums(m, cfar, prepadded_range)
        if cfar.variant == "ca":
            est = sum_refs // cfar.n_ref if integer else sum_refs / cfar.n_ref
        else:
            ml = lead // n_half if integer else lead / n_half
            mg = lag // n_half if integer else lag / n_half
            est = jnp.maximum(ml, mg) if cfar.variant == "go" else jnp.minimum(ml, mg)

    cut = m[cfar.halo_range:-cfar.halo_range] if prepadded_range else m
    if cfar.scale_mode == "block":
        if scale_map is not None:
            scale = scale_map.astype(jnp.int32)
        elif prepadded_range:
            raise ValueError(
                "scale_mode='block' with a prepadded (sharded) map needs "
                "the halo-exchanged scale_map from block_scale_map_sharded")
        else:
            scale = block_scale_map(cut, cfar, integer)
    else:
        if integer:
            mean = sum_refs // cfar.n_ref
            hi = est > mean + (mean >> 1)
            lo = est < (mean >> 1)
        else:
            mean = sum_refs / cfar.n_ref
            hi = est > 1.5 * mean
            lo = est < 0.5 * mean
        scale = _scale_select(hi, lo, cfar, 0)
    scale = jnp.where(so != 0, so, scale).astype(m.dtype)
    threshold = est * scale
    det = jnp.where(cut > threshold, cut, jnp.zeros_like(cut))
    return det.astype(in_dtype), threshold, scale


def _hw_stream_decide(ext, start0, R, D, S, cfar, integer,
                          scale_override, need_debug, pairs, layout):
    """The hw-compat per-cell decision over the flat stream, by counting
    (cfar_2d_count's formulation).  Returns flat (det, threshold, scale) in
    decision (true-cell) order; the caller applies the emission window and
    label roll.

    ``layout`` selects how the 128 training views are built — "flat"
    (misaligned 1D dynamic_slices of the ext stream) or "2d" (static
    row-block slices + lane concat of a row-aligned reshape)."""
    offs = [dr * D + dc for dr, dc in pairs]
    if layout == "2d":
        pad_head = (-start0) % D
        sr = (start0 + pad_head) // D            # row of the CUT's stream pos
        dr_max = max(dr for dr, _ in pairs)
        rows_total = sr + dr_max + R + 2         # +1 carry row, +1 slack
        pad_tail = rows_total * D - (pad_head + ext.shape[0])
        extp = jnp.pad(ext, (pad_head, max(pad_tail, 0)))
        if pad_tail < 0:
            extp = extp[:rows_total * D]
        m2 = extp.reshape(rows_total, D)

        def _view2(dr, dc):
            dc_n = dc % D
            dr_n = dr + (dc - dc_n) // D
            r0 = sr + dr_n
            if dc_n == 0:
                return m2[r0:r0 + R, :].reshape(-1)
            a = m2[r0:r0 + R, dc_n:]
            b = m2[r0 + 1:r0 + R + 1, :dc_n]
            return jnp.concatenate([a, b], axis=1).reshape(-1)

        views = {dr * D + dc: _view2(dr, dc) for dr, dc in pairs}

        def view(o):
            return views[o]

        cut = _view2(0, 0)
    else:
        def view(o):
            return jax.lax.dynamic_slice(ext, (start0 + o,), (S,))

        cut = jax.lax.dynamic_slice(ext, (start0,), (S,))
    so = jnp.asarray(scale_override)
    k = cfar.n_ref - cfar.rank_idx

    # Decision by COUNTING: est < q <=> #{refs >= q} < k, est > t <=>
    # #{refs > t} >= k.  The (S, n_ref) rank stack is never materialized —
    # each shifted view fuses into its comparisons.  The sum pass feeds the
    # adaptive-scale mean.
    sum_refs = None
    for o in offs:
        v = view(o)
        sum_refs = v if sum_refs is None else sum_refs + v
    if integer:
        mean = sum_refs // cfar.n_ref
        t_hi = mean + (mean >> 1)
        t_lo = mean >> 1
    else:
        mean = sum_refs / cfar.n_ref
        t_hi = jnp.asarray(1.5 * mean, cut.dtype)
        t_lo = jnp.asarray(0.5 * mean, cut.dtype)

    def qmin(s):
        return _count_threshold(cut, s, integer)

    q_lo = qmin(jnp.where(so != 0, so, cfar.scale_min))
    q_nom = qmin(jnp.where(so != 0, so, cfar.scale_nom))
    q_hi = qmin(jnp.where(so != 0, so, cfar.scale_max))
    z = jnp.zeros((S,), jnp.int32)
    c_hi, c_lo, n_lo, n_nom, n_hi = z, z, z, z, z
    for o in offs:
        v = view(o)
        c_hi = c_hi + (v > t_hi).astype(jnp.int32)
        c_lo = c_lo + (v >= t_lo).astype(jnp.int32)
        n_lo = n_lo + (v >= q_lo).astype(jnp.int32)
        n_nom = n_nom + (v >= q_nom).astype(jnp.int32)
        n_hi = n_hi + (v >= q_hi).astype(jnp.int32)
    hi = c_hi >= k
    lo = c_lo < k
    scale = _scale_select(hi, lo, cfar, so).astype(ext.dtype)
    cnt =jnp.where(hi, n_hi, jnp.where(lo, n_lo, n_nom))
    det = jnp.where((cnt < k) & (cut > 0), cut, jnp.zeros_like(cut))
    if need_debug:
        # est/threshold taps (dbg_threshold, os_cfar_2d.vhd:219): only here
        # is the rank stack materialized — debug pipelines, small maps.
        refs = jnp.stack([view(o) for o in offs], axis=-1)
        est = _order_statistic(refs, cfar.rank_idx)
        threshold = est * scale
    else:
        threshold = jnp.zeros_like(cut)
    return det, threshold, scale


@functools.partial(jax.jit,
                   static_argnames=("cfar", "integer", "streaming", "first",
                                    "need_debug", "layout", "label_roll"))
def cfar_2d_hw_stream(mag_map: jnp.ndarray,
                      scale_override: jnp.ndarray | int = 0,
                      cfar: CfarParams = CfarParams(),
                      integer: bool = True,
                      hist: jnp.ndarray | None = None,
                      streaming: bool = False,
                      first: bool = False,
                      need_debug: bool = True,
                      layout: str = "flat",
                      label_roll: bool = True):
    """As-built streaming-CFAR geometry — the opt-in hw-compat mode.

    JAX mirror of golden.fixed_point.os_cfar_2d_hw_stream for ONE frame:
    the crossed-axis window gathers over the flat range-major stream
    (training offsets (d_row*D + d_stream), _hw_stream_offsets), cells
    before the stream start read 0, the startup skip drops the first 3
    cells, and detections land at the hardware's label coordinates
    (label_flat = (true_flat - 3) mod frame_size).

    Two framings:

    * ``streaming=False`` (default): the frame is the whole stream — the
      one-shot / first-frame hardware behavior.  The final ``lag`` cells are
      never emitted (the hardware would emit them while the next frame
      streams in).
    * ``streaming=True`` with ``hist`` = the previous frame's last 2*lag
      stream cells: the steady-state behavior — decides stream positions
      [-lag, S-lag), i.e. the previous frame's tail (re-labeled into this
      frame's label space, as the hardware's free-running counter does) plus
      this frame's head.  Returns ``new_hist`` to carry.

    Returns (det_labeled, threshold, scale[, new_hist]):

    * det_labeled (R, D): zero-suppressed detections at LABEL coordinates —
      feed directly to detect.topk_detections for hardware-labeled output.
      ``label_roll=False`` skips the rotation and returns detections in
      decision (true-cell) order instead — for consumers that group peaks
      first (physical adjacency); apply ``hw_stream_label_shift`` after;
    * threshold / scale (R, D): debug taps in decision order (true cell
      coordinates for ``streaming=False``).

    ``streaming=True`` without ``hist`` forces ``first=True`` (no history
    IS the stream's first frame; the startup skip must suppress cells 0-2,
    whose training sets are mostly synthetic zeros).

    Integer maps narrower than 32 bits are upcast internally (cfar_2d
    note: the 128-view sum_refs and the ceil-division probe would wrap in
    int16); det_map and new_hist return in the input dtype (cut values
    fit), threshold/scale return int32 for narrow inputs — the same
    contract as cfar_2d.
    """
    if cfar.scale_mode != "cell":
        raise ValueError("hw-compat streaming CFAR is per-cell by definition")
    R, D = mag_map.shape
    S = R * D
    lag = hw_stream_lag(cfar, D)
    in_dtype = mag_map.dtype
    if jnp.issubdtype(in_dtype, jnp.integer) and in_dtype.itemsize < 4:
        mag_map = mag_map.astype(jnp.int32)
    flat = mag_map.reshape(-1)
    if streaming:
        if hist is None:
            # No history = this IS the stream's first frame: force the
            # startup suppression (cells 0-2 train on the synthetic zero
            # hist and would spuriously pass otherwise).
            hist = jnp.zeros((2 * lag,), flat.dtype)
            first = True
        h = hist.reshape(-1).astype(flat.dtype)
    else:
        h = jnp.zeros((2 * lag,), flat.dtype)
    ext = jnp.concatenate([h, flat, jnp.zeros((lag,), flat.dtype)])
    base = -lag if streaming else 0
    start0 = 2 * lag + base
    pairs = _hw_stream_offsets(cfar)

    det, threshold, scale = _hw_stream_decide(
        ext, start0, R, D, S, cfar, integer, scale_override, need_debug,
        pairs, layout)
    pos = jnp.arange(S) + base                          # stream positions
    if streaming:
        # steady state: every position emits.  ``first=True`` = the stream's
        # first frame: the startup skip suppresses positions < 3 (positions
        # < 0 compute on the zero hist and can never detect, but cells 0-2
        # have mostly-zero training sets and WOULD spuriously pass).
        emitted = (pos >= 3) if first else jnp.ones((S,), dtype=bool)
        shift = lag + 3
    else:
        emitted = (pos >= 3) & (pos < S - lag)
        shift = 3
    det = jnp.where(emitted, det, jnp.zeros_like(det))
    if label_roll:
        det = jnp.roll(det, -shift)
    out = (det.reshape(R, D).astype(in_dtype), threshold.reshape(R, D),
           scale.reshape(R, D))
    if streaming:
        return out + (flat[-2 * lag:].astype(in_dtype),)
    return out


def hw_stream_label_shift(cfar: CfarParams, n_doppler: int,
                          streaming: bool) -> int:
    """Flat-cell shift from decision (true-cell) order to the hardware's
    label coordinates for cfar_2d_hw_stream(label_roll=False) consumers:
    apply ``jnp.roll(det.reshape(-1), -shift)``.  Peak grouping must run in
    decision order (physical adjacency) BEFORE this roll — label space is
    rotated 3 flat cells, so true neighbors straddling the seam are label
    rows apart (models/pipeline.py does this)."""
    return (hw_stream_lag(cfar, n_doppler) + 3) if streaming else 3


def cfar_1d(x: jnp.ndarray, ref_cells: int = 8, guard_cells: int = 2,
            rank_idx: int = 12, scaling_mult: int = 4, scaling_div: int = 1,
            axis: int = -1, edge_mode: str = "wrap") -> jnp.ndarray:
    """1D OS-CFAR along ``axis`` (rtl/old/os_cfar.vhd semantics: ascending
    rank over 2*ref_cells training cells, fixed mult/div threshold).  The
    order statistic uses top_k like the 2D path; integer inputs use floor
    division for the threshold (matching the VHDL), floats true division."""
    x = jnp.moveaxis(x, axis, -1)
    offs = ([-(guard_cells + i) - 1 for i in range(ref_cells)]
            + [guard_cells + i + 1 for i in range(ref_cells)])
    if edge_mode == "wrap":
        refs = jnp.stack([jnp.roll(x, -o, axis=-1) for o in offs], axis=-1)
    else:
        h = ref_cells + guard_cells
        pad = [(0, 0)] * (x.ndim - 1) + [(h, h)]
        xp = jnp.pad(x, pad, mode="reflect")
        n = x.shape[-1]
        refs = jnp.stack([xp[..., h + o: h + o + n] for o in offs], axis=-1)
    n_ref = 2 * ref_cells
    est = _order_statistic(refs, rank_idx)
    if jnp.issubdtype(x.dtype, jnp.integer):
        threshold = (est * scaling_mult) // scaling_div
    else:
        threshold = est * (scaling_mult / scaling_div)
    out = jnp.where(x > threshold, x, jnp.zeros_like(x))
    return jnp.moveaxis(out, -1, axis)


def _offsets_3d(cfar: CfarParams, ref_angle: int, guard_angle: int):
    """Training offsets (da, dr, dd) of cfar_3d's box-minus-guard-box
    neighborhood, in construction order."""
    offs = []
    for da in range(-(ref_angle + guard_angle), ref_angle + guard_angle + 1):
        for d in range(cfar.win_doppler):
            for r in range(cfar.win_range):
                if (abs(da) <= guard_angle
                        and abs(d - cfar.halo_doppler) <= cfar.guard_doppler
                        and abs(r - cfar.halo_range) <= cfar.guard_range):
                    continue
                offs.append((da, r - cfar.halo_range, d - cfar.halo_doppler))
    return offs


def cfar_3d(cube: jnp.ndarray, scale_override: jnp.ndarray | int = 0,
            cfar: CfarParams = CfarParams(), integer: bool = False,
            ref_angle: int = 0, guard_angle: int = 0, method: str = "auto",
            prepadded_angle: bool = False, need_debug: bool = True):
    """Angle-bin extension of the 2D CFAR (BASELINE config 4).

    ``cube``: (n_angle, n_range, n_doppler) magnitude maps, one per beam.

    * ``ref_angle == 0``: independent 2D CFAR per angle bin (vmapped
      cfar_2d_auto; ``method`` and ``need_debug`` pick its route).
    * ``ref_angle > 0``: the training window extends +-ref_angle planes in
      angle (with +-guard_angle guard planes, wrap edges), forming a 3D
      box-minus-guard-box neighborhood; the order statistic / averages run
      over the enlarged training set.  The percentile rank follows
      CfarParams.rank_pct on the enlarged n_ref.  The decision is the
      stacked top_k body below (``method`` "auto" or "topk"; no counting
      route in 3D yet).

    ``prepadded_angle`` (ref_angle > 0 only): the cube already carries
    ``ref_angle + guard_angle`` halo planes on each side of axis 0 — the
    beam-axis halo exchange of parallel/sharded.make_sharded_array_processor
    supplies the neighbor shards' planes, so no angle edge padding is
    applied here (range/Doppler still pad with ``cfar.edge_mode``).  The
    returned maps cover only the interior planes.

    Returns (det_cube, threshold, scale) like cfar_2d.
    """
    if prepadded_angle and ref_angle == 0:
        raise ValueError("prepadded_angle needs ref_angle > 0")
    if ref_angle == 0:
        f = lambda m: cfar_2d_auto(m, scale_override, cfar=cfar,
                                   integer=integer, method=method,
                                   need_debug=need_debug)
        return jax.vmap(f)(cube)
    if method not in ("auto", "topk"):
        raise ValueError(f"cfar method {method!r} has no compiled route for "
                         f"the angle-extended CFAR; choose 'auto' or 'topk'")

    offs3 = _offsets_3d(cfar, ref_angle, guard_angle)
    n_ref = len(offs3)
    rank_idx = min((n_ref * cfar.rank_pct) // 100, n_ref - 1)

    in_dtype = cube.dtype
    if jnp.issubdtype(in_dtype, jnp.integer) and in_dtype.itemsize < 4:
        # est*scale would wrap in narrow integer dtypes (cfar_2d note).
        cube = cube.astype(jnp.int32)

    ha = ref_angle + guard_angle
    hr, hd = cfar.halo_range, cfar.halo_doppler
    if prepadded_angle:
        padded = jnp.pad(cube, ((0, 0), (hr, hr), (hd, hd)),
                         mode=cfar.edge_mode)
        cube = cube[ha:-ha]                        # interior planes = CUTs
    else:
        padded = jnp.pad(cube, ((ha, ha), (hr, hr), (hd, hd)),
                         mode=cfar.edge_mode)
    A, R, D = cube.shape

    def view(da, dr, dd):
        return jax.lax.dynamic_slice(padded, (ha + da, hr + dr, hd + dd),
                                     (A, R, D))

    views = [view(da, dr, dd) for da, dr, dd in offs3]
    refs = jnp.stack(views, axis=-1)
    sum_refs = jnp.sum(refs, axis=-1)
    if cfar.variant == "os":
        est = _order_statistic(refs, rank_idx)
    elif cfar.variant == "ca":
        est = sum_refs // n_ref if integer else sum_refs / n_ref
    elif cfar.variant in ("go", "so"):
        # Pure leading/lagging range blocks across all angle planes.
        o = np.array(offs3)
        lead_idx = np.nonzero(o[:, 1] < -cfar.guard_range)[0]
        lag_idx = np.nonzero(o[:, 1] > cfar.guard_range)[0]
        lead = sum(views[int(i)] for i in lead_idx)
        lag = sum(views[int(i)] for i in lag_idx)
        nl, ng = len(lead_idx), len(lag_idx)
        ml = lead // nl if integer else lead / nl
        mg = lag // ng if integer else lag / ng
        est = jnp.maximum(ml, mg) if cfar.variant == "go" else jnp.minimum(ml, mg)
    else:
        raise ValueError(cfar.variant)

    so = jnp.asarray(scale_override)
    if integer:
        mean = sum_refs // n_ref
        hi = est > mean + (mean >> 1)
        lo = est < (mean >> 1)
    else:
        mean = sum_refs / n_ref
        hi = est > 1.5 * mean
        lo = est < 0.5 * mean
    scale = _scale_select(hi, lo, cfar, so).astype(cube.dtype)
    threshold = est * scale
    det = jnp.where(cube > threshold, cube, jnp.zeros_like(cube))
    return det.astype(in_dtype), threshold, scale


def peak_group(det_map: jnp.ndarray, radius: int = 1,
               row_ids: jnp.ndarray | None = None) -> jnp.ndarray:
    """Peak grouping: keep detections that are the strict local max of their
    (2r+1)^2 neighborhood, ties broken toward the lower linear index (matches
    golden fixed_point.peak_group).

    ``row_ids``: optional global row index per input row — pass it when the
    input is a halo-extended shard (parallel/sharded.py) so tie-breaking uses
    the same global ids as the single-chip path (a tie straddling the global
    wrap seam would otherwise resolve by inverted local ids)."""
    m = det_map
    R, D = m.shape
    p = jnp.pad(m, ((radius, radius), (radius, radius)), mode="wrap")
    rows = jnp.arange(R) if row_ids is None else row_ids.astype(jnp.int32)
    ids = rows[:, None] * D + jnp.arange(D)[None, :]
    pid = jnp.pad(ids, ((radius, radius), (radius, radius)), mode="wrap")
    best = jnp.full_like(m, jnp.iinfo(jnp.int32).min if
                         jnp.issubdtype(m.dtype, jnp.integer) else -jnp.inf)
    best_id = jnp.zeros_like(ids)
    for dr in range(2 * radius + 1):
        for dd in range(2 * radius + 1):
            nb = jax.lax.dynamic_slice(p, (dr, dd), (R, D))
            nid = jax.lax.dynamic_slice(pid, (dr, dd), (R, D))
            take = (nb > best) | ((nb == best) & (nid < best_id))
            best = jnp.where(take, nb, best)
            best_id = jnp.where(take, nid, best_id)
    keep = (m > 0) & (best == m) & (best_id == ids)
    return jnp.where(keep, m, jnp.zeros_like(m))


def peak_group_beams(det_cube: jnp.ndarray, radius: int = 1,
                     beam_ids: jnp.ndarray | None = None) -> jnp.ndarray:
    """Beam-axis peak grouping for the array model: keep det_cube[b, r, d]
    only if it is the maximum over beams b-radius..b+radius at the SAME
    (r, d) cell, ties toward the LOWER beam index (the tie rule of
    peak_group).  Beamforming never shifts a target's range/Doppler cell,
    so a target straddling adjacent beams collapses to its strongest beam;
    combine with per-beam 2D peak_group for full (beam, range, doppler)
    grouping.  The beam axis is NOT periodic (beam 0 and beam B-1 point
    60 degrees apart): edges compare only against existing neighbors.

    ``beam_ids``: optional global beam index per input plane — pass it for
    a halo-extended beam shard (parallel/sharded.py) so the strict-compare
    direction uses global beam order."""
    m = det_cube
    B = m.shape[0]
    keep = m > 0
    if beam_ids is None:
        # Contiguous-id fast path (the single-device model case):
        # neighbors are plain shifted views with zero-filled edges — the
        # zero fill IS the edge semantics (a missing neighbor never beats
        # m > 0), and beam order equals index order, so no id planes, no
        # validity masks, no rolls: fewer map-sized intermediates than the
        # general path.
        z = jnp.zeros_like(m[:1])
        for o in range(1, radius + 1):
            up = jnp.concatenate([m[o:]] + [z] * o, axis=0)     # beam b+o
            dn = jnp.concatenate([z] * o + [m[:-o]], axis=0)    # beam b-o
            # Tie toward the lower beam: a lower-index neighbor wins equals.
            keep &= (m >= up) & (m > dn)
        return jnp.where(keep, m, jnp.zeros_like(m))
    b_ids = beam_ids.astype(jnp.int32)
    for o in range(-radius, radius + 1):
        if o == 0:
            continue
        nb = jnp.roll(m, -o, axis=0)
        nid = jnp.roll(b_ids, -o)
        # Rolled-in wrap planes must not count: the beam axis has edges.
        valid = ((nid[:, None, None] - b_ids[:, None, None]) == o)
        nb = jnp.where(valid, nb, jnp.zeros_like(nb))
        # Tie toward the lower beam: a lower-index neighbor wins equals.
        keep &= (m > nb) if o < 0 else (m >= nb)
    return jnp.where(keep, m, jnp.zeros_like(m))
