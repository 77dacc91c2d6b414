"""Multi-device radar pipeline: shard_map over a ('dp', 'sp') mesh.

The reference's single-chip dataflow maps onto the mesh as (SURVEY.md §2d):

* frames  -> ``dp`` axis (batch data parallelism);
* within a frame, the **corner turn becomes an all-to-all**: chirps are
  sharded over ``sp`` for the range FFT, then ``lax.all_to_all`` redistributes
  so each chip holds a contiguous block of range bins for the MTI/Doppler/
  magnitude stages (the mesh realization of the ping-pong BRAM transpose,
  rtl/src/corner_turner.vhd:79-117 — the frame barrier of SURVEY.md CS-2);
* the CFAR training window needs halo_range rows from both range-neighbors:
  a **ppermute ring halo exchange** supplies them (the torus edge semantics
  match the single-chip "wrap" CFAR bit-for-bit);
* detections: each device extracts its local top-K with globally-offset range
  coordinates, then an all_gather + global top-K reproduces the single-chip
  detection list on every device.

Outputs are replicated across the mesh (identical to the single-chip result;
verified bit-exact in tests/test_sharded.py).
"""

from __future__ import annotations


import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..params import RadarParams
from ..routes import resolve_routes
from ..ops import window as W, fft as F, notch as N, magnitude as M
from ..ops import cfar as C, detect as DET


def _halo_exchange_rows(m: jnp.ndarray, h: int, axis_name: str,
                        edge_mode: str = "wrap") -> jnp.ndarray:
    """Halo exchange: prepend the previous shard's last ``h`` rows and append
    the next shard's first ``h`` rows (ring ppermute over the ``sp`` axis —
    the reference's line-buffer wrap-around at frame edges).

    ``edge_mode="reflect"``: interior shard boundaries still take neighbor
    rows, but the global edges mirror locally (np.pad 'reflect' semantics:
    the row above global row 0 is row 1), reproducing the single-chip
    reflect pad exactly.  The shard must hold at least h+1 rows."""
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # data moves to next shard
    bwd = [(i, (i - 1) % n) for i in range(n)]
    top = jax.lax.ppermute(m[-h:], axis_name, fwd)   # becomes upper halo
    bot = jax.lax.ppermute(m[:h], axis_name, bwd)    # becomes lower halo
    if edge_mode == "reflect":
        idx = jax.lax.axis_index(axis_name)
        top = jnp.where(idx == 0, m[1:h + 1][::-1], top)
        bot = jnp.where(idx == n - 1, m[-h - 1:-1][::-1], bot)
    return jnp.concatenate([top, m, bot], axis=0)


def make_sharded_processor(mesh: jax.sharding.Mesh,
                           params: RadarParams | None = None,
                           mode: str = "float32",
                           fft_method: str = "matmul",
                           precision=jax.lax.Precision.HIGHEST,
                           window_rounding: str = "unbiased",
                           mti_transient: str = "zero",
                           peak_group_radius: int = 0,
                           magnitude_exact: bool = False,
                           cfar_method: str = "auto",
                           include_maps: bool = False,
                           include_debug: bool = False):
    """Build the sharded frame-batch processor.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0) -> dict``
    with iq int16[(batch, n_doppler, n_range, 2)], batch divisible by the dp
    axis, n_doppler and n_range divisible by the sp axis.  Detection outputs
    are replicated; map outputs (include_maps) come back range-sharded over sp
    and batch-sharded over dp.  Routes resolve as on the single device
    (``routes.resolve_routes`` with ``sp``; ``process.routes``), so the
    detection set equals the single-device processor's: exactly in fixed
    mode, and in float mode up to the matmul summation order.
    """
    p = params or RadarParams()
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    if p.n_doppler % sp or p.n_range % sp:
        raise ValueError(f"n_doppler={p.n_doppler} and n_range={p.n_range} "
                         f"must divide the sp axis ({sp})")
    max_dets = p.tracker.max_dets
    nr_local = p.n_range // sp
    hr = p.cfar.halo_range
    if sp > 1 and max(hr, peak_group_radius) > nr_local:
        # The single-hop ring exchange supplies at most one neighbor
        # shard's rows per side.
        raise ValueError(
            f"CFAR halo_range ({hr}) and peak_group_radius "
            f"({peak_group_radius}) must not exceed the local range extent "
            f"(n_range/sp = {nr_local})")
    if p.cfar.edge_mode == "reflect" and hr + 1 > nr_local and sp > 1:
        raise ValueError(
            f"edge_mode='reflect' needs halo_range+1 <= n_range/sp "
            f"({hr + 1} > {nr_local}) for the edge shards' local mirror")
    if p.cfar.scale_mode == "block" and nr_local % p.cfar.scale_block:
        raise ValueError(
            f"scale_mode='block' needs the local range extent "
            f"({nr_local} = n_range/sp) divisible by "
            f"scale_block={p.cfar.scale_block}")
    routes = resolve_routes(p, mode=mode, fft_method=fft_method,
                            cfar_method=cfar_method,
                            include_debug=include_debug,
                            magnitude_exact=magnitude_exact, sp=sp)

    def frame_fn(iq, mti_bypass, scale_override):
        """Per-(dp-shard, sp-shard) single-frame body.  iq local shape:
        (n_doppler/sp, n_range, 2)."""
        sp_idx = jax.lax.axis_index("sp")

        def finish(local, local_r, sat, nonfinite, maps):
            """Gather the shards' local top-K detections and re-extract the
            global top-K on every device."""
            all_mag = jax.lax.all_gather(local["mag"], "sp", tiled=True)
            all_r = jax.lax.all_gather(local_r, "sp", tiled=True)
            all_d = jax.lax.all_gather(local["doppler_bin"], "sp",
                                       tiled=True)
            vals, idx = jax.lax.top_k(all_mag, max_dets)
            out = {
                "range_bin": all_r[idx],
                "doppler_bin": all_d[idx],
                "mag": vals,
                "valid": vals > 0,
                "n_dets": jax.lax.psum(local["n_dets"], "sp"),
                "saturation_count": sat,
                "nonfinite_count": nonfinite,
            }
            out.update(maps)
            return out

        if routes.slow_time == "folded":
            re = iq[..., 0].astype(jnp.float32)
            im = iq[..., 1].astype(jnp.float32)
            # Range window+FFT on the local chirp block (full range axis).
            re, im = F.fft_apply(re, im, axis=1, window=True,
                                 method=routes.range_fft, precision=precision)
            # Corner turn: all-to-all splits the range axis over sp and
            # gathers all chirps -> (nd, nr_local) chirp-major shard; the
            # fused Doppler operator (window+MTI+DFT, ops/fft.py) contracts
            # the chirp axis directly, landing range-major — same op order
            # as the single-chip float path.
            re, im = [jax.lax.all_to_all(x, "sp", split_axis=1, concat_axis=0,
                                         tiled=True) for x in (re, im)]
            re, im = F.doppler_apply(re, im, axis=0, bypass=mti_bypass,
                                     notch_mode=p.notch_mode,
                                     transient=mti_transient,
                                     precision=precision)
            mag = M.magnitude_float(re, im,
                                    exact=routes.magnitude == "exact")
            sat = jnp.int32(0)
            nonfinite = jax.lax.psum(
                jnp.sum(~jnp.isfinite(mag)).astype(jnp.int32), "sp")
        else:
            i_v = iq[..., 0].astype(jnp.int32)
            q_v = iq[..., 1].astype(jnp.int32)
            cr = W.hamming_q15(p.n_range, p.coef_width)
            i_v, q_v, s1 = W.window_apply_fixed(i_v, q_v, cr[None, :],
                                                p.coef_width, window_rounding)
            re, im = F.fft_apply(i_v.astype(jnp.float32),
                                 q_v.astype(jnp.float32), axis=1,
                                 method=routes.range_fft, precision=precision)
            re, im = F.bfp_quantize(re, im, axis=1)
            re, im = [jax.lax.all_to_all(x, "sp", split_axis=1, concat_axis=0,
                                         tiled=True).T for x in (re, im)]
            i_v, q_v = re.astype(jnp.int32), im.astype(jnp.int32)
            i_v, q_v = N.mti_notch_fixed(i_v, q_v, axis=1, mode=p.notch_mode,
                                         bypass=mti_bypass,
                                         transient=mti_transient)
            cd = W.hamming_q15(p.n_doppler, p.coef_width)
            i_v, q_v, s2 = W.window_apply_fixed(i_v, q_v, cd[None, :],
                                                p.coef_width, window_rounding)
            re, im = F.fft_apply(i_v.astype(jnp.float32),
                                 q_v.astype(jnp.float32), axis=1,
                                 method=routes.range_fft, precision=precision)
            re, im = F.bfp_quantize(re, im, axis=1)
            mag = M.magnitude_fixed(re.astype(jnp.int32), im.astype(jnp.int32))
            sat = jax.lax.psum(s1 + s2, "sp").astype(jnp.int32)
            nonfinite = jnp.int32(0)

        # CFAR with cross-shard halo (ring exchange along sp; reflect edges
        # mirror locally on the edge shards).  Block-mode adaptive scale
        # computes its block statistics with a block-grid halo exchange
        # (bytes, not map rows) — bit-identical to the single-chip
        # semantics in either edge mode.
        scale_map = None
        if p.cfar.scale_mode == "block":
            scale_map = C.block_scale_map_sharded(
                mag, p.cfar, integer=(mode == "fixed"), axis_name="sp")
        mag_h = _halo_exchange_rows(mag, hr, "sp", p.cfar.edge_mode)
        with jax.named_scope("cfar"):
            det, threshold, dbg_scale = C.cfar_2d_auto(
                mag_h, scale_override, cfar=p.cfar,
                integer=(mode == "fixed"), prepadded_range=True,
                method=routes.cfar, need_debug=include_debug,
                scale_map=scale_map)
        if peak_group_radius > 0:
            # Peak grouping also needs neighbor context; reuse the exchange.
            # Global row ids keep tie-breaking identical to single chip even
            # across the global wrap seam.
            det_h = _halo_exchange_rows(det, peak_group_radius, "sp")
            gr = (sp_idx * nr_local
                  + jnp.arange(-peak_group_radius,
                               nr_local + peak_group_radius)) % p.n_range
            det = C.peak_group(det_h, radius=peak_group_radius,
                               row_ids=gr)[
                peak_group_radius:-peak_group_radius]

        # Local detection extraction with global range coordinates, then
        # gather + global top-K so every chip holds the frame's detections.
        local = DET.topk_detections(det, max_dets=max_dets)
        maps = {"mag_map": mag, "det_map": det} if include_maps else {}
        if include_debug:
            # The dbg_threshold/dbg_scale taps (os_cfar_2d.vhd:34-35,
            # 219-220), sp-sharded like the maps; halo-correct because the
            # decision above consumed the exchanged halo.
            maps["threshold_map"] = threshold
            maps["scale_map"] = dbg_scale
        return finish(local, local["range_bin"] + sp_idx * nr_local,
                      sat, nonfinite, maps)

    def batch_fn(iq, mti_bypass, scale_override):
        # iq local: (batch/dp, n_doppler/sp, n_range, 2); vmap over frames.
        return jax.vmap(frame_fn, in_axes=(0, None, None))(
            iq, mti_bypass, scale_override)

    rep_spec = P("dp")  # detection outputs: replicated over sp, per-frame rows
    out_specs = {
        "range_bin": rep_spec, "doppler_bin": rep_spec, "mag": rep_spec,
        "valid": rep_spec, "n_dets": rep_spec, "saturation_count": rep_spec,
        "nonfinite_count": rep_spec,
    }
    if include_maps:
        out_specs["mag_map"] = P("dp", "sp", None)
        out_specs["det_map"] = P("dp", "sp", None)
    if include_debug:
        out_specs["threshold_map"] = P("dp", "sp", None)
        out_specs["scale_map"] = P("dp", "sp", None)

    sharded = jax.jit(jax.shard_map(
        batch_fn, mesh=mesh,
        in_specs=(P("dp", "sp", None, None), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    ))

    return _make_process_wrapper(sharded, mesh, P("dp", "sp", None, None),
                                 (p.n_doppler, p.n_range, 2), dp, routes,
                                 what="iq batch")


def _make_process_wrapper(sharded, mesh, in_spec, expected_tail, dp,
                          routes, what="iq batch"):
    """Shared host-side entry for the sharded processors (single place for
    the multi-host input contract, so the frame and array models cannot
    drift): strict shape checks, traced runtime controls, replicated-numpy
    staging on multi-process meshes."""
    multi_process = len({d.process_index for d in mesh.devices.flat}) > 1

    def _ctrl(x, dtype):
        # Traced runtime control: a 0-d numpy array stays a *dynamic* jit
        # argument (a Python scalar would be hashed static and recompile per
        # value) and, unlike a committed jnp scalar, is a valid input to a
        # multi-process (multi-host) mesh computation — every process passes
        # the same host value and jit replicates it over the global mesh.
        return x if isinstance(x, jax.Array) else np.asarray(x, dtype)

    def process(iq, mti_bypass=False, scale_override=0):
        if (iq.ndim != 1 + len(expected_tail)
                or tuple(iq.shape[1:]) != expected_tail):
            raise ValueError(
                f"expected {what} of shape (batch, "
                + ", ".join(str(d) for d in expected_tail)
                + f"), got {iq.shape}")
        if iq.shape[0] % dp:
            raise ValueError(f"batch {iq.shape[0]} not divisible by dp={dp}")
        if multi_process and not isinstance(iq, jax.Array):
            # Multi-host mesh fed host-local numpy frames: every process
            # must supply the identical batch (the standard replicated-input
            # contract); each process materializes only its addressable
            # shards.  Callers with genuinely distributed data pass a global
            # jax.Array instead (tools/multihost_worker.py shows both).
            spec = jax.sharding.NamedSharding(mesh, in_spec)
            arr = np.asarray(iq)
            iq = jax.make_array_from_callback(arr.shape, spec,
                                              lambda idx: arr[idx])
        return sharded(iq, _ctrl(mti_bypass, np.bool_),
                       _ctrl(scale_override, np.int32))

    process.jitted = sharded
    process.routes = routes
    return process


def make_sharded_array_processor(mesh: jax.sharding.Mesh,
                                 params: RadarParams | None = None,
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
                                 include_maps: bool = False,
                                 peak_group_radius: int = 0,
                                 beam_group_radius: int = 0):
    """Multi-device array-radar model: batch over ``dp``, BEAMS over ``sp``.

    Sharding design (the angle-axis analog of make_sharded_processor's
    range sharding): the element-space cube is replicated over sp — every
    beam needs every element — and each device forms its ``n_beams/sp``
    beam block and runs the per-beam front-end + CFAR on it.  The steering
    matmul runs in full on every device (it is ~1e-4 of the front-end
    FLOPs) and the local block is sliced out, so the local beams' float ops
    are IDENTICAL to the single-device model's.  ``ref_angle > 0`` training
    sets span neighbor beams: a ppermute ring halo exchange supplies the
    ``ref_angle + guard_angle`` neighbor beam planes
    (ops/cfar.cfar_3d ``prepadded_angle``), matching the single-device wrap
    (or reflect) angle-edge semantics bit-for-bit.  Detections come back
    replicated: local top-K with global beam ids -> all_gather -> global
    top-K, same detection set as pipeline.make_array_processor.

    Peak grouping follows pipeline.make_array_processor:
    ``peak_group_radius`` per beam (shard-local), ``beam_group_radius``
    across beams — the cross-shard case ring-exchanges the neighbor beam
    planes and passes true global beam ids so the non-periodic beam-edge
    semantics match the single device exactly.

    Returned callable: ``fn(iq, mti_bypass=False, scale_override=0)`` with
    iq int16[(batch, n_elems, n_doppler, n_range, 2)], batch divisible by
    dp, n_beams divisible by sp.  ``include_maps`` adds mag/det cubes,
    batch-sharded over dp and beam-sharded over sp.
    """
    p = params or RadarParams()
    from ..models import pipeline as PL
    from ..ops import beamform as BF
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    if n_beams % sp:
        raise ValueError(f"n_beams={n_beams} must divide the sp axis ({sp})")
    bl = n_beams // sp
    ha = ref_angle + guard_angle
    if ref_angle > 0 and sp > 1:
        if ha > bl:
            # Single-hop ring exchange: at most one neighbor shard's planes.
            raise ValueError(
                f"angle halo (ref_angle+guard_angle = {ha}) must not exceed "
                f"the local beam extent (n_beams/sp = {bl})")
        if p.cfar.edge_mode == "reflect" and ha + 1 > bl:
            raise ValueError(
                f"edge_mode='reflect' needs ref_angle+guard_angle+1 <= "
                f"n_beams/sp ({ha + 1} > {bl}) for the edge shards' mirror")
    if sp > 1 and beam_group_radius > bl:
        raise ValueError(
            f"beam_group_radius ({beam_group_radius}) must not exceed the "
            f"local beam extent (n_beams/sp = {bl})")
    max_dets = p.tracker.max_dets
    # The same resolution as the single-device array model it is
    # parity-tested against.
    routes = resolve_routes(p, fft_method=fft_method,
                            cfar_method=cfar_method,
                            magnitude_exact=magnitude_exact,
                            ref_angle=ref_angle)

    def frame_fn(iq, mti_bypass, scale_override):
        """Per-(dp, sp) shard single-cube body.  iq local shape:
        (n_elems, n_doppler, n_range, 2) — elements replicated over sp."""
        sp_idx = jax.lax.axis_index("sp")
        re = iq[..., 0].astype(jnp.float32)
        im = iq[..., 1].astype(jnp.float32)
        br, bi = BF.beamform(re, im, n_beams, spacing_wl=spacing_wl,
                             max_angle_deg=max_angle_deg, taper=taper,
                             precision=precision)
        br = jax.lax.dynamic_slice_in_dim(br, sp_idx * bl, bl, axis=0)
        bi = jax.lax.dynamic_slice_in_dim(bi, sp_idx * bl, bl, axis=0)
        cube = jax.vmap(lambda r, i: PL.float_beam_frontend(
            r, i, mti_bypass, p, routes, precision, mti_transient))(br, bi)                  # (bl, nr, nd)
        nonfinite = jnp.sum(~jnp.isfinite(cube)).astype(jnp.int32)
        cfar_kw = dict(cfar=p.cfar, integer=False, ref_angle=ref_angle,
                       guard_angle=guard_angle, need_debug=False,
                       method=routes.cfar if ref_angle == 0 else "auto")
        if ref_angle > 0 and sp > 1:
            # Cross-beam training set: ring-exchange the neighbor shards'
            # ha beam planes (wrap == the single-device pad; reflect
            # mirrors locally on the edge shards).
            cube_h = _halo_exchange_rows(cube, ha, "sp", p.cfar.edge_mode)
            det, _, _ = C.cfar_3d(cube_h, scale_override,
                                  prepadded_angle=True, **cfar_kw)
        else:
            det, _, _ = C.cfar_3d(cube, scale_override, **cfar_kw)
        if peak_group_radius > 0:
            det = jax.vmap(
                lambda d: C.peak_group(d, radius=peak_group_radius))(det)
        if beam_group_radius > 0:
            if sp == 1:
                det = C.peak_group_beams(det, radius=beam_group_radius)
            else:
                # Ring-halo the neighbor shards' planes; true global beam
                # ids make the non-periodic edge semantics exact.
                ext = _halo_exchange_rows(det, beam_group_radius, "sp")
                gids = (sp_idx * bl
                        + jnp.arange(-beam_group_radius,
                                     bl + beam_group_radius)) % n_beams
                ext = C.peak_group_beams(ext, radius=beam_group_radius,
                                         beam_ids=gids)
                det = ext[beam_group_radius:-beam_group_radius]
        flat = det.reshape(bl * p.n_range, p.n_doppler)
        local = DET.topk_detections(flat, max_dets=max_dets)
        local_b = local["range_bin"] // p.n_range + sp_idx * bl
        local_r = local["range_bin"] % p.n_range
        maps = {"mag_cube": cube, "det_cube": det} if include_maps else {}

        all_mag = jax.lax.all_gather(local["mag"], "sp", tiled=True)
        all_b = jax.lax.all_gather(local_b, "sp", tiled=True)
        all_r = jax.lax.all_gather(local_r, "sp", tiled=True)
        all_d = jax.lax.all_gather(local["doppler_bin"], "sp", tiled=True)
        vals, idx = jax.lax.top_k(all_mag, max_dets)
        out = {
            "beam_bin": all_b[idx],
            "range_bin": all_r[idx],
            "doppler_bin": all_d[idx],
            "mag": vals,
            "valid": vals > 0,
            "n_dets": jax.lax.psum(local["n_dets"], "sp"),
            "saturation_count": jnp.int32(0),
            "nonfinite_count": jax.lax.psum(nonfinite, "sp"),
        }
        out.update(maps)
        return out

    def batch_fn(iq, mti_bypass, scale_override):
        return jax.vmap(frame_fn, in_axes=(0, None, None))(
            iq, mti_bypass, scale_override)

    rep_spec = P("dp")
    out_specs = {
        "beam_bin": rep_spec, "range_bin": rep_spec, "doppler_bin": rep_spec,
        "mag": rep_spec, "valid": rep_spec, "n_dets": rep_spec,
        "saturation_count": rep_spec, "nonfinite_count": rep_spec,
    }
    if include_maps:
        out_specs["mag_cube"] = P("dp", "sp", None, None)
        out_specs["det_cube"] = P("dp", "sp", None, None)

    sharded = jax.jit(jax.shard_map(
        batch_fn, mesh=mesh,
        in_specs=(P("dp", None, None, None, None), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    ))

    return _make_process_wrapper(sharded, mesh,
                                 P("dp", None, None, None, None),
                                 (n_elems, p.n_doppler, p.n_range, 2), dp,
                                 routes, what="element-space iq batch")
