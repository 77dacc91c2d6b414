"""Detection-quality evaluation: Pd / Pfa Monte-Carlo harness.

The reference validates its detector statistically in-testbench — "at least
2 detections on targets, at most 3 false alarms on noise-only"
(rtl/src/tb_os_cfar_2d.vhd:131-155).  This module is the framework-grade
version of that idea: Monte-Carlo probability-of-detection curves vs SNR and
noise-only false-alarm rates, per CFAR variant and scale mode — the radar
analog of a model-quality eval, runnable on the CPU or the GPU.

Definitions:

* A trial frame is complex white Gaussian noise (per-component sigma, int16
  quantized) with, for Pd trials, one point target of input-domain SNR
  ``A^2 / (2 sigma^2)`` at a known (range, Doppler) bin (off-grid fractional
  frequencies by default — the honest case; straddling loss included).
* Pd = fraction of trials where any reported detection falls within
  ``tolerance`` bins (Chebyshev) of the truth.
* Pfa = false detections per cell on noise-only frames (n_dets / cells,
  averaged over trials).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import RadarParams


def synth_trial_frame(p: RadarParams, rng: np.random.Generator,
                      snr_db: float | None, rbin: float, dbin: float,
                      sigma: float = 64.0) -> np.ndarray:
    """One int16 I/Q trial frame: noise, plus a point target at fractional
    bins (rbin, dbin) when ``snr_db`` is not None."""
    nd, nr = p.n_doppler, p.n_range
    z = rng.normal(0.0, sigma, (nd, nr)) + 1j * rng.normal(0.0, sigma,
                                                           (nd, nr))
    if snr_db is not None:
        amp = sigma * np.sqrt(2.0) * 10.0 ** (snr_db / 20.0)
        n = np.arange(nr)[None, :]
        c = np.arange(nd)[:, None]
        phase = 2j * np.pi * (rbin * n / nr + dbin * c / nd)
        z = z + amp * np.exp(phase + 2j * np.pi * rng.uniform())
    z = np.clip(np.round(z.real), -32768, 32767) + 1j * np.clip(
        np.round(z.imag), -32768, 32767)
    iq = np.stack([z.real, z.imag], axis=-1).astype(np.int16)
    return iq


def pd_pfa(p: RadarParams, *, snr_dbs=(-35, -30, -27, -24, -21, -18),
           variants=("os", "ca", "go", "so"), trials: int = 32,
           noise_trials: int = 16, seed: int = 0, tolerance: int = 1,
           sigma: float = 64.0, mti_bypass: bool = True,
           processor_kw: dict | None = None,
           truth_doppler_offset: float = 0.0,
           range_hi_margin: int = 0) -> dict:
    """Monte-Carlo Pd(SNR) curves and noise-only Pfa per CFAR variant.

    Targets are injected at random fractional bins away from the Doppler
    notch (``mti_bypass=True`` by default so zero-Doppler placement is also
    fair; pass False to include the MTI in the chain).  Returns
    ``{variant: {"pfa": float, "pd": {snr_db: float}}}``.

    For the hw-compat detector (``processor_kw={"cfar_geometry":
    "hw_stream"}``) pass ``truth_doppler_offset=-3`` — detections come
    back at the hardware's label coordinates, 3 flat cells behind the true
    cell (docs/design_notes.md §4; Pfa is count-based and unaffected) —
    and ``range_hi_margin`` covering the one-shot framing's never-emitted
    tail (ceil(lag/n_doppler)+1 range rows), so truth placement stays
    inside the emission window.
    """
    import jax
    from ..models import pipeline as pl

    results = {}
    cells = p.n_range * p.n_doppler
    for variant in variants:
        pv = p.replace(cfar=dataclasses.replace(p.cfar, variant=variant))
        proc = pl.make_batch_processor(pv, include_maps=False,
                                       **(processor_kw or {}))
        rng = np.random.default_rng(seed)

        noise = np.stack([
            synth_trial_frame(pv, rng, None, 0, 0, sigma)
            for _ in range(noise_trials)])
        out = jax.tree.map(np.asarray,
                           proc(noise, mti_bypass=mti_bypass))
        pfa = float(out["n_dets"].sum()) / (noise_trials * cells)

        pd_curve = {}
        for snr in snr_dbs:
            truths = []
            batch = []
            # Doppler placement margin: the CFAR halo always; with the MTI
            # in the chain also an n/8 guard away from the DC notch (bins 0
            # and N wrap), where the 2-pulse canceller still attenuates by
            # ~-1 dB or worse — otherwise notch-skirt losses flatten the Pd
            # curves and the docstring's "fair placement" claim breaks.
            dmargin = p.cfar.halo_doppler + 1
            if not mti_bypass:
                dmargin = max(dmargin, p.n_doppler // 8)
            for _ in range(trials):
                rbin = rng.uniform(p.cfar.halo_range + 1,
                                   p.n_range - p.cfar.halo_range - 2
                                   - range_hi_margin)
                dbin = rng.uniform(dmargin, p.n_doppler - dmargin - 1)
                truths.append((rbin, dbin))
                batch.append(synth_trial_frame(pv, rng, snr, rbin, dbin,
                                               sigma))
            out = jax.tree.map(
                np.asarray, proc(np.stack(batch), mti_bypass=mti_bypass))
            hits = 0
            for i, (rbin, dbin) in enumerate(truths):
                v = out["valid"][i]
                if not v.any():
                    continue
                dr = np.abs(out["range_bin"][i][v] - rbin)
                dr = np.minimum(dr, p.n_range - dr)       # wrap distance
                dd = np.abs(out["doppler_bin"][i][v]
                            - (dbin + truth_doppler_offset))
                dd = np.minimum(dd, p.n_doppler - dd)
                if (np.maximum(dr, dd) <= tolerance + 0.5).any():
                    hits += 1
            pd_curve[snr] = hits / trials
        results[variant] = {"pfa": pfa, "pd": pd_curve}
    return results


def format_table(results: dict) -> str:
    """Plain-text Pd/Pfa table (one row per variant)."""
    snrs = sorted(next(iter(results.values()))["pd"])
    cols = [f"Pd@{s:+g}dB" for s in snrs]
    hdr = "variant   Pfa       " + "  ".join(cols)
    lines = [hdr, "-" * len(hdr)]
    for v, r in results.items():
        row = f"{v:8s}  {r['pfa']:.2e}  " + "  ".join(
            f"{r['pd'][s]:{len(c)}.2f}" for s, c in zip(snrs, cols))
        lines.append(row)
    return "\n".join(lines)


def synth_trial_cube(p: RadarParams, rng: np.random.Generator,
                     snr_db: float | None, bbin: float, rbin: float,
                     dbin: float, n_elems: int, n_beams: int,
                     sigma: float = 64.0, spacing_wl: float = 0.5,
                     max_angle_deg: float = 60.0) -> np.ndarray:
    """One int16 element-space trial cube (n_elems, nd, nr, 2): independent
    noise per element, plus (Pd trials) a point target whose inter-element
    phase matches the steering sine of fractional beam ``bbin`` — the
    conjugate of ops/beamform.steering_matrix's weight phase, so the
    delay-and-sum beamformer integrates it coherently in that beam.
    ``snr_db`` is the PER-ELEMENT input SNR; beamforming adds the array
    gain (~10*log10(n_elems)) on top."""
    nd, nr = p.n_doppler, p.n_range
    z = (rng.normal(0.0, sigma, (n_elems, nd, nr))
         + 1j * rng.normal(0.0, sigma, (n_elems, nd, nr)))
    if snr_db is not None:
        amp = sigma * np.sqrt(2.0) * 10.0 ** (snr_db / 20.0)
        us = np.linspace(-np.sin(np.deg2rad(max_angle_deg)),
                         np.sin(np.deg2rad(max_angle_deg)), n_beams)
        u_t = np.interp(bbin, np.arange(n_beams), us)
        e = np.arange(n_elems)[:, None, None]
        steer = np.exp(2j * np.pi * spacing_wl * e * u_t)
        n = np.arange(nr)[None, None, :]
        c = np.arange(nd)[None, :, None]
        phase = 2j * np.pi * (rbin * n / nr + dbin * c / nd)
        z = z + amp * steer * np.exp(phase + 2j * np.pi * rng.uniform())
    z = np.clip(np.round(z.real), -32768, 32767) + 1j * np.clip(
        np.round(z.imag), -32768, 32767)
    return np.stack([z.real, z.imag], axis=-1).astype(np.int16)


def pd_pfa_3d(p: RadarParams, *, n_elems: int = 8, n_beams: int = 8,
              ref_angle: int = 1, guard_angle: int = 0,
              snr_dbs=(-35, -30, -27, -24, -21, -18),
              trials: int = 32, noise_trials: int = 16, seed: int = 0,
              tolerance: int = 1, beam_tolerance: int = 1,
              sigma: float = 64.0, mti_bypass: bool = True,
              processor_kw: dict | None = None) -> dict:
    """Pd(SNR)/Pfa for the angle-extended (3D) detector — the array model
    with ``ref_angle`` neighbor-beam training planes (ops/cfar.cfar_3d,
    BASELINE config 4).  A hit requires a detection within
    ``beam_tolerance`` beams AND ``tolerance`` range/Doppler bins of truth;
    Pfa counts per CUBE cell (n_beams x n_range x n_doppler).  ``snr_dbs``
    are per-element — compare against the 2D curves at
    snr + 10*log10(n_elems) to see the detector's own behavior net of
    array gain.  Returns {"os": {"pfa", "pd"}} (the 3D extension keeps the
    OS order statistic; other variants follow CfarParams as usual)."""
    import jax
    from ..models import pipeline as pl

    proc = pl.make_batch_array_processor(
        p, n_elems=n_elems, n_beams=n_beams, ref_angle=ref_angle,
        guard_angle=guard_angle, include_maps=False,
        **(processor_kw or {}))
    rng = np.random.default_rng(seed)
    cells = n_beams * p.n_range * p.n_doppler

    noise = np.stack([
        synth_trial_cube(p, rng, None, 0, 0, 0, n_elems, n_beams, sigma)
        for _ in range(noise_trials)])
    out = jax.tree.map(np.asarray, proc(noise, mti_bypass=mti_bypass))
    pfa = float(out["n_dets"].sum()) / (noise_trials * cells)

    bmargin = ref_angle + guard_angle
    dmargin = p.cfar.halo_doppler + 1
    if not mti_bypass:
        dmargin = max(dmargin, p.n_doppler // 8)
    pd_curve = {}
    for snr in snr_dbs:
        truths, batch = [], []
        for _ in range(trials):
            bbin = rng.uniform(bmargin, n_beams - 1 - bmargin)
            rbin = rng.uniform(p.cfar.halo_range + 1,
                               p.n_range - p.cfar.halo_range - 2)
            dbin = rng.uniform(dmargin, p.n_doppler - dmargin - 1)
            truths.append((bbin, rbin, dbin))
            batch.append(synth_trial_cube(p, rng, snr, bbin, rbin, dbin,
                                          n_elems, n_beams, sigma))
        out = jax.tree.map(np.asarray,
                           proc(np.stack(batch), mti_bypass=mti_bypass))
        hits = 0
        for i, (bbin, rbin, dbin) in enumerate(truths):
            v = out["valid"][i]
            if not v.any():
                continue
            db = np.abs(out["beam_bin"][i][v] - bbin)
            dr = np.abs(out["range_bin"][i][v] - rbin)
            dr = np.minimum(dr, p.n_range - dr)
            dd = np.abs(out["doppler_bin"][i][v] - dbin)
            dd = np.minimum(dd, p.n_doppler - dd)
            if ((db <= beam_tolerance + 0.5)
                    & (np.maximum(dr, dd) <= tolerance + 0.5)).any():
                hits += 1
        pd_curve[snr] = hits / trials
    return {p.cfar.variant: {"pfa": pfa, "pd": pd_curve}}
