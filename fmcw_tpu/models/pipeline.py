"""Single-device radar pipeline — the framework's "model".

Array-program equivalent of the reference top (rtl/src/radar_core.vhd:267-418):
one jitted program per frame instead of nine streaming AXI stages.

    window -> range FFT -> corner turn -> MTI -> window -> Doppler FFT
           -> magnitude -> 2D CFAR -> (peak group) -> top-K detections

Two numeric modes:

* ``float32`` (production): windows folded into the DFT matmuls, float
  MTI/magnitude/CFAR.  Fastest path; full dynamic range (no BFP compression).
* ``fixed`` (parity): bit-faithful int16/int32 emulation of the reference's
  inter-stage formats — integer windows with saturation counters, per-
  transform BFP quantization, saturating MTI, integer magnitude and CFAR.
  Matches golden/reference.process_frame_fixed to <=1 LSB per FFT stage.

Runtime controls are traced arguments (mti_bypass, cfar_scale_override) —
the radar_core control ports (rtl/src/radar_core.vhd:48-49); shape/static
config lives in RadarParams (the generics).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..params import RadarParams
from ..routes import resolve_routes
from ..ops import window as W, fft as F, notch as N, magnitude as M
from ..ops import cfar as C, detect as DET


def complex_to_iq(frame: np.ndarray) -> np.ndarray:
    """Pack a complex frame into the ingest format: int16 (..., 2) I/Q pairs
    (== the reference's 32-bit interleaved s_axis_tdata, radar_core.vhd:26)."""
    z = np.asarray(frame)
    return np.stack([z.real, z.imag], axis=-1).astype(np.int16)


def make_processor(params: RadarParams | None = None, mode: str = "float32",
                   fft_method: str = "matmul",
                   precision=jax.lax.Precision.HIGHEST,
                   window_rounding: str = "unbiased",
                   mti_transient: str = "zero",
                   peak_group_radius: int = 0,
                   magnitude_exact: bool = False,
                   cfar_method: str = "auto",
                   include_maps: bool = True,
                   include_debug: bool = False,
                   cfar_geometry: str = "named",
                   fixed_fft: str = "bfp",
                   fixed_fft_scale_sch=None) -> Callable:
    """Build the jitted single-frame processor.

    Every stage's route comes from ``routes.resolve_routes`` (exposed as
    ``process.routes``); an option no compiled route implements raises.

    ``fixed_fft`` (mode='fixed' only): "bfp" (default — the production
    XFFT instances' block-floating-point, golden/fixed_point.bfp_fft) or
    "scaled" — the QUICK-mode XFFT variants' stage-scaled fixed arithmetic
    (golden/fixed_point.scaled_fft: radix-2 DIF, Q15 twiddles, convergent
    rounding, per-stage shifts, int16 wrap on overflow; design_notes §3).
    ``fixed_fft_scale_sch``: optional (range_sch, doppler_sch) pair of
    per-stage shift schedules; None = the conventional [1]*log2(n)
    1/N scaling per transform (pass ([0]*10, [0]*7)-style zeros to model
    the reference's as-wired x"0001" config word — no scaling, wraps).

    ``cfar_method``: "auto" (counting OS decision unless debug taps are
    requested), "count" or "topk" (ops/cfar.cfar_route).

    ``cfar_geometry``: "named" (framework default — ref_range/guard_range
    govern the range axis, window wraps per axis) or "hw_stream" — the
    opt-in hw-compat mode reproducing the reference's AS-BUILT streaming
    CFAR (crossed-axis geometry, flat-stream Doppler window, startup skip,
    and the -3-flat-cell detection label offset; ops/cfar.cfar_2d_hw_stream,
    docs/design_notes.md §4).  hw_stream implies per-cell OS semantics and
    reports detections / det_map at the hardware's LABEL coordinates.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) -> dict``
    with iq int16[(n_doppler, n_range, 2)].  Output dict:

      mag_map   (n_range, n_doppler) magnitude map   [if include_maps]
      det_map   zero-suppressed CFAR output          [if include_maps]
      range_bin/doppler_bin/mag/valid  top-K detection arrays
      n_dets    total CFAR detection count
      saturation_count  windowed-sample saturations (fixed mode; 0 in float)
      threshold_map/scale_map  CFAR debug taps       [if include_debug]
          (the dbg_threshold/dbg_scale ports, os_cfar_2d.vhd:34-35)
      nonfinite_count  NaN/Inf cells in the magnitude map (float mode
          numeric sanitization; always 0 in fixed mode)
    """
    p = params or RadarParams()
    max_dets = p.tracker.max_dets
    routes = resolve_routes(p, mode=mode, fft_method=fft_method,
                            cfar_method=cfar_method,
                            cfar_geometry=cfar_geometry,
                            include_debug=include_debug,
                            magnitude_exact=magnitude_exact,
                            fixed_fft=fixed_fft)
    hw_cfar = routes.cfar == "hw_stream"
    scaled_fft = routes.range_fft == "scaled"
    if scaled_fft:
        _sch = fixed_fft_scale_sch or (
            [1] * (p.n_range.bit_length() - 1),
            [1] * (p.n_doppler.bit_length() - 1))
    else:
        _sch = None

    integer = mode == "fixed"

    def float_front(iq, mti_bypass):
        re = iq[..., 0].astype(jnp.float32)
        im = iq[..., 1].astype(jnp.float32)
        # Range window+FFT fused into one GEMM per component.
        with jax.named_scope("range_fft"):
            re, im = F.fft_apply(re, im, axis=1, window=True,
                                 method=routes.range_fft, precision=precision)
        # Whole slow-time chain — corner turn + MTI + window + Doppler
        # DFT — as ONE matrix contraction over the chirp axis
        # (ops/fft.py doppler_matrices): chirp-major in, range-major
        # out, no transpose or per-stage intermediates materialized.
        # Across devices the corner turn is the all_to_all instead
        # (parallel/sharded.py).
        with jax.named_scope("slow_time"):
            re, im = F.doppler_apply(re, im, axis=0, bypass=mti_bypass,
                                     notch_mode=p.notch_mode,
                                     transient=mti_transient,
                                     precision=precision)
        with jax.named_scope("magnitude"):
            mag = M.magnitude_float(re, im,
                                    exact=routes.magnitude == "exact")
        nonfinite = jnp.sum(~jnp.isfinite(mag)).astype(jnp.int32)
        return mag, jnp.int32(0), nonfinite

    def fixed_front(iq, mti_bypass):
        i_v = iq[..., 0].astype(jnp.int32)
        q_v = iq[..., 1].astype(jnp.int32)
        with jax.named_scope("range_fft"):
            cr = W.hamming_q15(p.n_range, p.coef_width)
            i_v, q_v, s1 = W.window_apply_fixed(i_v, q_v, cr[None, :],
                                                p.coef_width, window_rounding)
            if scaled_fft:
                i_v, q_v = F.scaled_fft_apply(i_v, q_v, axis=1,
                                              scale_sch=tuple(_sch[0]))
                i_v, q_v = i_v.T, q_v.T
            else:
                re, im = F.fft_apply(i_v.astype(jnp.float32),
                                     q_v.astype(jnp.float32),
                                     axis=1, method=routes.range_fft,
                                     precision=precision)
                re, im = F.bfp_quantize(re, im, axis=1)
                i_v, q_v = re.astype(jnp.int32).T, im.astype(jnp.int32).T
        with jax.named_scope("slow_time"):
            i_v, q_v = N.mti_notch_fixed(i_v, q_v, axis=1,
                                         mode=p.notch_mode,
                                         bypass=mti_bypass,
                                         transient=mti_transient)
            cd = W.hamming_q15(p.n_doppler, p.coef_width)
            i_v, q_v, s2 = W.window_apply_fixed(i_v, q_v, cd[None, :],
                                                p.coef_width, window_rounding)
            if scaled_fft:
                re, im = F.scaled_fft_apply(i_v, q_v, axis=1,
                                            scale_sch=tuple(_sch[1]))
            else:
                re, im = F.fft_apply(i_v.astype(jnp.float32),
                                     q_v.astype(jnp.float32),
                                     axis=1, method=routes.range_fft,
                                     precision=precision)
                re, im = F.bfp_quantize(re, im, axis=1)
        with jax.named_scope("magnitude"):
            mag = M.magnitude_fixed(re.astype(jnp.int32),
                                    im.astype(jnp.int32))
        return mag, (s1 + s2).astype(jnp.int32), jnp.int32(0)

    front = float_front if routes.slow_time == "folded" else fixed_front

    def finish(mag, det, threshold, scale, sat, nonfinite, label_shift):
        """Grouping, label roll (hw_stream) and top-K extraction."""
        if peak_group_radius > 0:
            with jax.named_scope("grouping"):
                det = C.peak_group(det, radius=peak_group_radius)
        if label_shift:
            # Grouping ran in decision (true-cell) order — physical
            # adjacency; only now rotate into the hardware's label space
            # (C.hw_stream_label_shift: true neighbors straddling the
            # 3-cell seam would otherwise be label rows apart).
            det = jnp.roll(det.reshape(-1), -label_shift).reshape(det.shape)
        with jax.named_scope("topk"):
            out = DET.topk_detections(det, max_dets=max_dets)
        out["saturation_count"] = sat
        out["nonfinite_count"] = nonfinite
        if include_maps:
            out["mag_map"] = mag
            out["det_map"] = det
        if include_debug:
            out["threshold_map"] = threshold
            out["scale_map"] = scale
        return out

    @jax.jit
    def _process(iq, mti_bypass, scale_override):
        mag, sat, nonfinite = front(iq, mti_bypass)
        with jax.named_scope("cfar"):
            if hw_cfar:
                det, threshold, scale = C.cfar_2d_hw_stream(
                    mag, scale_override, cfar=p.cfar, integer=integer,
                    need_debug=include_debug, label_roll=False)
            else:
                det, threshold, scale = C.cfar_2d_auto(
                    mag, scale_override, cfar=p.cfar, integer=integer,
                    method=routes.cfar, need_debug=include_debug)
        shift = (C.hw_stream_label_shift(p.cfar, p.n_doppler,
                                         streaming=False) if hw_cfar else 0)
        return finish(mag, det, threshold, scale, sat, nonfinite, shift)

    def process(iq, mti_bypass=False, scale_override=0):
        # Strict single-frame shape: a batched (B, nd, nr, 2) array would
        # pass a trailing-dims check and then trace the FFTs over the wrong
        # axes (use make_batch_processor / vmap for batches).
        if tuple(iq.shape) != (p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected iq frame of shape (n_doppler={p.n_doppler}, "
                f"n_range={p.n_range}, 2), got {iq.shape}")
        # Controls become device arrays *outside* the jit boundary so every
        # control value reuses one compiled executable (Python scalars would
        # be hashed as static constants and recompile per value).
        return _process(iq, jnp.asarray(mti_bypass, dtype=jnp.bool_),
                        jnp.asarray(scale_override, dtype=jnp.int32))

    if hw_cfar:
        from ..golden.fixed_point import hw_stream_lag
        hlen = 2 * hw_stream_lag(p.cfar, p.n_doppler)
        hdtype = jnp.int32 if mode == "fixed" else jnp.float32

        @functools.partial(jax.jit, static_argnames=("first",))
        def _process_stream(iq, mti_bypass, scale_override, hist,
                            first=False):
            mag, sat, nonfinite = front(iq, mti_bypass)
            with jax.named_scope("cfar"):
                det, threshold, scale, new_hist = C.cfar_2d_hw_stream(
                    mag, scale_override, cfar=p.cfar, integer=integer,
                    hist=hist, streaming=True, first=first,
                    need_debug=include_debug, label_roll=False)
            shift = C.hw_stream_label_shift(p.cfar, p.n_doppler,
                                            streaming=True)
            return (finish(mag, det, threshold, scale, sat, nonfinite, shift),
                    new_hist)

        def process_stream(iq, mti_bypass=False, scale_override=0,
                           hist=None):
            """Continuous-stream hw-compat call: the steady-state hardware
            behavior across CPIs.  ``hist`` is the previous call's returned
            carry (None = this is the stream's first frame: zero line
            buffer + startup skip).  Returns (out, hist) where out covers
            the hardware's output batch for this frame's input window —
            the previous frame's tail cells (re-labeled, as the hardware's
            free-running counter does) plus this frame's head.  Driving
            every frame of a run through this matches
            golden.fixed_point.os_cfar_2d_hw_stream on the concatenated
            stream exactly (tests/test_hw_compat.py)."""
            first = hist is None
            if first:
                hist = jnp.zeros((hlen,), hdtype)
            return _process_stream(
                iq, jnp.asarray(mti_bypass, dtype=jnp.bool_),
                jnp.asarray(scale_override, dtype=jnp.int32),
                jnp.asarray(hist, dtype=hdtype), first=first)

        process.stream = process_stream

    process.jitted = _process
    process.routes = routes
    return process


def float_beam_frontend(re, im, mti_bypass, p: RadarParams, routes,
                        precision, mti_transient: str):
    """One beam's float front-end (range FFT -> folded slow-time operator
    -> magnitude) on beamformed (n_doppler, n_range) I/Q, on the stage
    routes of ``routes``; shared by the single-chip and the beam-sharded
    array models."""
    with jax.named_scope("range_fft"):
        re, im = F.fft_apply(re, im, axis=1, window=True,
                             method=routes.range_fft, precision=precision)
    with jax.named_scope("slow_time"):
        re, im = F.doppler_apply(re, im, axis=0, bypass=mti_bypass,
                                 notch_mode=p.notch_mode,
                                 transient=mti_transient,
                                 precision=precision)
    with jax.named_scope("magnitude"):
        return M.magnitude_float(re, im, exact=routes.magnitude == "exact")


def make_array_processor(params: RadarParams | None = None,
                         n_elems: int = 8, n_beams: int = 8,
                         fft_method: str = "matmul",
                         precision=jax.lax.Precision.HIGHEST,
                         mti_transient: str = "zero",
                         magnitude_exact: bool = False,
                         ref_angle: int = 0, guard_angle: int = 0,
                         spacing_wl: float = 0.5,
                         max_angle_deg: float = 60.0,
                         taper: str | None = None,
                         cfar_method: str = "auto",
                         include_maps: bool = True,
                         peak_group_radius: int = 0,
                         beam_group_radius: int = 0) -> Callable:
    """Array-radar model (the BASELINE config-4 angle extension at model
    level): element-space I/Q -> ULA phase-shift beamformer (ops/beamform,
    one matmul over the element axis) -> per-beam range-Doppler front-end
    -> 3D angle-extended CFAR (ops/cfar.cfar_3d) -> top-K detections with
    (beam, range, doppler) coordinates.  ``ref_angle == 0`` decides each
    beam with the 2D route of ``cfar_method``; ``ref_angle > 0`` spans
    neighbor beams with the stacked 3D body.

    Peak grouping: ``peak_group_radius`` groups each beam's 2D map
    (ops/cfar.peak_group semantics), then ``beam_group_radius`` collapses
    cross-beam duplicates of the same (range, doppler) cell to the strongest
    beam (ops/cfar.peak_group_beams — the beam axis is not periodic).  A
    target detected in several adjacent beams otherwise floods the
    fixed-capacity detection buffer with copies of itself.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0)`` with
    iq int16[(n_elems, n_doppler, n_range, 2)].  Output adds ``beam_bin``
    to the usual detection arrays; ``include_maps`` returns the
    (n_beams, n_range, n_doppler) magnitude and detection cubes.
    """
    p = params or RadarParams()
    from ..ops import beamform as BF
    max_dets = p.tracker.max_dets
    routes = resolve_routes(p, fft_method=fft_method,
                            cfar_method=cfar_method,
                            magnitude_exact=magnitude_exact,
                            ref_angle=ref_angle)

    @jax.jit
    def _process(iq, mti_bypass, scale_override):
        re = iq[..., 0].astype(jnp.float32)
        im = iq[..., 1].astype(jnp.float32)
        with jax.named_scope("beamform"):
            br, bi = BF.beamform(re, im, n_beams, spacing_wl=spacing_wl,
                                 max_angle_deg=max_angle_deg, taper=taper,
                                 precision=precision)
        cube = jax.vmap(lambda r, i: float_beam_frontend(
            r, i, mti_bypass, p, routes, precision, mti_transient))(br, bi)               # (B, n_range, n_doppler)
        with jax.named_scope("cfar"):
            det, _, _ = C.cfar_3d(cube, scale_override, cfar=p.cfar,
                                  integer=False, ref_angle=ref_angle,
                                  guard_angle=guard_angle,
                                  method=routes.cfar if ref_angle == 0
                                  else "auto", need_debug=False)
        with jax.named_scope("grouping"):
            if peak_group_radius > 0:
                det = jax.vmap(
                    lambda d: C.peak_group(d, radius=peak_group_radius))(det)
            if beam_group_radius > 0:
                det = C.peak_group_beams(det, radius=beam_group_radius)
        flat = det.reshape(n_beams * p.n_range, p.n_doppler)
        with jax.named_scope("topk"):
            out = DET.topk_detections(flat, max_dets=max_dets)
        out["beam_bin"] = out["range_bin"] // p.n_range
        out["range_bin"] = out["range_bin"] % p.n_range
        out["saturation_count"] = jnp.int32(0)
        out["nonfinite_count"] = jnp.sum(
            ~jnp.isfinite(cube)).astype(jnp.int32)
        if include_maps:
            out["mag_cube"] = cube
            out["det_cube"] = det
        return out

    def process(iq, mti_bypass=False, scale_override=0):
        if iq.shape != (n_elems, p.n_doppler, p.n_range, 2):
            raise ValueError(
                f"expected element-space iq of shape ({n_elems}, "
                f"{p.n_doppler}, {p.n_range}, 2), got {iq.shape}")
        return _process(iq, jnp.asarray(mti_bypass, dtype=jnp.bool_),
                        jnp.asarray(scale_override, dtype=jnp.int32))

    process.jitted = _process
    process.routes = routes
    return process


def make_batch_processor(params: RadarParams | None = None, **kw) -> Callable:
    """vmapped multi-frame processor: iq int16[(batch, n_doppler, n_range, 2)]
    -> dict of batched outputs.  Data parallelism over frames on one chip;
    shard the batch axis over a mesh for multi-chip DP (parallel/sharded.py)."""
    single = make_processor(params, **kw)
    batched = jax.jit(jax.vmap(single.jitted, in_axes=(0, None, None)))

    def process(iq, mti_bypass=False, scale_override=0):
        return batched(iq, jnp.asarray(mti_bypass, dtype=jnp.bool_),
                       jnp.asarray(scale_override, dtype=jnp.int32))

    process.jitted = batched
    process.routes = single.routes
    return process


def make_batch_array_processor(params: RadarParams | None = None,
                               **kw) -> Callable:
    """vmapped multi-cube array processor: iq int16[(batch, n_elems,
    n_doppler, n_range, 2)] -> batched make_array_processor outputs.  Feeds
    runtime/surveillance.run_surveillance with element-space scan batches
    (the detection keys match the single-channel batch processor's; the
    extra beam_bin rides along)."""
    single = make_array_processor(params, **kw)
    batched = jax.jit(jax.vmap(single.jitted, in_axes=(0, None, None)))

    def process(iq, mti_bypass=False, scale_override=0):
        return batched(iq, jnp.asarray(mti_bypass, dtype=jnp.bool_),
                       jnp.asarray(scale_override, dtype=jnp.int32))

    process.jitted = batched
    process.routes = single.routes
    return process
