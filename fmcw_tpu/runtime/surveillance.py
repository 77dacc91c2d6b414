"""Surveillance runtime: scan-rate frame batching + tracker loop.

BASELINE config 5 ("many-frame batch (tracking-rate) throughput"): frames
arrive at kHz rates while the tracker runs at scan rate (~Hz).  This runtime
ties the pieces together for a long-running air picture:

* frames are processed in device batches (single-chip batch processor or the
  sharded multi-chip processor) — one dispatch covers many scans' CPIs;
* the tracker consumes one frame's detections per scan, advancing its carried
  pytree state (host-side step per scan; the tracker costs microseconds next
  to the frame pipeline);
* detection/track logs stream out in the reference text formats, so
  model/visualize_radar_targets.py-style analysis works on the output.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import jax
import jax.numpy as jnp

from ..params import RadarParams
from ..models import tracker as jt
from ..utils import io as rio


def _to_host(a) -> np.ndarray:
    """Device array -> host numpy.  On a multi-host mesh the detection
    outputs are batch-sharded across processes (not fully addressable);
    gather them so every host drives the same tracker state and writes
    identical logs — detections are ~KB/scan, so the DCN gather is free
    next to the frame pipeline."""
    if isinstance(a, jax.Array) and not a.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


class SurveillanceStallError(RuntimeError):
    """A frame-batch dispatch (or its device->host readback) exceeded the
    watchdog timeout — the runtime analog of the reference testbenches'
    cycle-count watchdog processes (tb_radar_core.vhd:136-146), which abort
    a hung simulation instead of blocking forever."""


def _with_watchdog(fn: Callable, timeout: float | None, what: str):
    """Run ``fn`` under a wall-clock watchdog.  On timeout the stalled call
    keeps running on a daemon thread (a hung device call cannot be
    cancelled), but the runtime surfaces SurveillanceStallError immediately
    so the caller can fail over / restart instead of hanging.  Only None
    disables the watchdog (a zero/near-zero budget still guards — it trips
    unless fn is already done — rather than silently running unguarded)."""
    if timeout is None:
        return fn()
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # surfaced in the caller's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise SurveillanceStallError(
            f"{what} exceeded the {timeout:.3g}s watchdog timeout")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _write_scan_logs(det_log: str | None, trk_log: str | None,
                     range_bin, doppler_bin, mag, v, rep) -> None:
    """Append one scan's detections + track reports in the reference text
    formats — the single place the log line layout lives (both the batched
    and the hw-compat streaming runners write through here, so the
    byte-identical-logs resume contract cannot drift between them)."""
    if det_log:
        rio.write_detections(det_log, range_bin[v], doppler_bin[v], mag[v],
                             append=True)
    if trk_log:
        ids = np.nonzero(rep["report_mask"])[0]
        rio.write_tracks(trk_log, [
            {"id": t, "range_pos": rep["range_pos"][t],
             "dopp_pos": rep["dopp_pos"][t],
             "range_vel": rep["range_vel"][t],
             "quality": rep["quality"][t],
             "status": rep["status"][t]} for t in ids],
            active_count=int(rep["active_tracks"]), append=True)


@dataclasses.dataclass
class ScanResult:
    scan: int
    n_dets: int
    active_tracks: int
    report: dict
    tracker_state: dict | None  # populated on each batch's final scan (the
    # checkpoint boundary — utils.checkpoint); None on intermediate scans
    stream_hist: np.ndarray | None = None  # hw-compat streaming CFAR carry
    # (run_surveillance_stream only): part of the checkpointable runtime
    # state — resuming without it replays the startup-skip transient


def run_surveillance(proc: Callable, frames: Iterable[np.ndarray],
                     params: RadarParams, batch_scans: int = 8,
                     det_log: str | None = None, trk_log: str | None = None,
                     mti_bypass: bool = False, scale_override: int = 0,
                     tracker_state: dict | None = None,
                     start_scan: int = 0,
                     watchdog_timeout: float | None = None,
                     health: Callable[[str], None] | None = None
                     ) -> Iterator[ScanResult]:
    """Drive ``proc`` (a make_batch_processor / make_sharded_processor
    callable) over ``frames``, batching ``batch_scans`` CPIs per dispatch and
    stepping the TWS tracker once per scan.  Yields a ScanResult per scan.

    ``tracker_state``/``start_scan`` allow resuming from a checkpoint
    (utils/checkpoint.py).

    ``watchdog_timeout``: wall-clock seconds a single frame-batch dispatch
    (including its device->host readback — where device stalls surface) may take before the runtime raises SurveillanceStallError
    instead of blocking forever — the TB watchdog analog
    (tb_radar_core.vhd:136-146).  None disables it.  First-dispatch
    compilation counts toward the budget; size it to cover compile time or
    warm the processor first.

    ``health``: optional callback receiving one status line per batch
    (scan counter, detections, active tracks, batch wall time and scan
    rate) — the runtime's live observability tap, mirroring the reference
    TBs' periodic ``report`` progress lines (tb_tactical.vhd:239-244).
    """
    if batch_scans < 1:
        raise ValueError(f"batch_scans must be >= 1, got {batch_scans}")
    tp = params.tracker
    state = tracker_state if tracker_state is not None else jt.init_state(tp)
    resuming = tracker_state is not None or start_scan > 0
    # A fresh run starts new logs; a resumed run appends to the existing ones.
    if not resuming:
        if det_log:
            open(det_log, "w").close()
        if trk_log:
            open(trk_log, "w").close()

    scan = start_scan
    buf: list[np.ndarray] = []

    def flush(buf):
        nonlocal scan, state
        n_valid = len(buf)
        # Zero-pad the final partial batch: keeps the dispatch shape constant
        # (one compiled executable; sharded processors need batch % dp == 0)
        # at the cost of processing a few dummy frames once per run.
        if n_valid < batch_scans:
            buf = buf + [np.zeros_like(buf[0])] * (batch_scans - n_valid)
        batch = np.stack(buf)
        t0 = time.perf_counter()

        def dispatch():
            o = proc(batch, mti_bypass=mti_bypass,
                     scale_override=scale_override)
            return jax.tree.map(_to_host, o)

        out = _with_watchdog(dispatch, watchdog_timeout,
                             f"frame batch ending at scan {scan + n_valid}")
        batch_dt = time.perf_counter() - t0
        # All of the batch's scans advance the tracker in one on-device
        # lax.scan dispatch (models/tracker.run_scans), then reports stream
        # out per scan.  (A final partial batch runs a shorter scan loop —
        # one extra tracker compile per run; the expensive frame-processor
        # executable keeps its shape.)
        state_dev = {k: jnp.asarray(v) for k, v in state.items()}
        final, reps = jt.run_scans(
            jnp.asarray(out["range_bin"][:n_valid]),
            jnp.asarray(out["doppler_bin"][:n_valid]),
            jnp.asarray(out["mag"][:n_valid].astype(np.int32)),
            jnp.asarray(out["valid"][:n_valid]),
            tp=tp, state=state_dev)
        reps = jax.tree.map(np.asarray, reps)
        state = {k: np.asarray(v) for k, v in final.items()}
        if health is not None:
            n_dets_batch = int(out["valid"][:n_valid].sum())
            act = int(reps["active_tracks"][n_valid - 1])
            health(f"HEALTH scans={scan + 1}-{scan + n_valid} "
                   f"dets={n_dets_batch} active={act} "
                   f"batch_s={batch_dt:.3f} "
                   f"scan_rate={n_valid / max(batch_dt, 1e-9):.1f}/s")
        for i in range(n_valid):
            scan += 1
            v = out["valid"][i]
            rep = {k: val[i] for k, val in reps.items()}
            _write_scan_logs(det_log, trk_log, out["range_bin"][i],
                             out["doppler_bin"][i], out["mag"][i], v, rep)
            # tracker_state after intermediate scans is not materialized by
            # the fused scan; expose it on the batch's final scan (the
            # checkpointing boundary).
            st = state if i == n_valid - 1 else None
            yield ScanResult(scan=scan, n_dets=int(np.sum(v)),
                             active_tracks=int(rep["active_tracks"]),
                             report=rep, tracker_state=st)

    for f in frames:
        buf.append(f)
        if len(buf) == batch_scans:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)


def run_surveillance_stream(proc, frames: Iterable[np.ndarray],
                            params: RadarParams,
                            det_log: str | None = None,
                            trk_log: str | None = None,
                            mti_bypass: bool = False,
                            scale_override: int = 0,
                            tracker_state: dict | None = None,
                            stream_hist: np.ndarray | None = None,
                            start_scan: int = 0) -> Iterator[ScanResult]:
    """Hw-compat STREAMING surveillance: one CPI at a time through
    ``proc.stream`` (make_processor(cfar_geometry='hw_stream') — the
    continuous-stream behavior of the hardware's free-running CFAR,
    os_cfar_2d.vhd:66-68/130-135), tracker stepped per scan, logs in the
    reference text formats.

    The run's full state between scans is (tracker_state, scan counter,
    ``stream_hist`` — the CFAR's inter-frame line-buffer tail).  Checkpoint
    all three with utils.checkpoint (``runtime_state={'stream_hist': ...,
    **checkpoint.log_positions(...)}``) and a resumed run continues the
    stream exactly: same detection sets (no startup-skip replay), byte-
    identical logs (tests/test_surveillance.py pins this).
    """
    tp = params.tracker
    state = (tracker_state if tracker_state is not None
             else jt.init_state(tp))
    hist = None if stream_hist is None else jnp.asarray(stream_hist)
    # Any carried state means "resuming" (same convention as
    # run_surveillance): a caller restoring tracker_state/stream_hist but
    # keeping its own scan numbering must not have the existing logs
    # truncated out from under it.
    resuming = (tracker_state is not None or stream_hist is not None
                or start_scan > 0)
    if not resuming:
        if det_log:
            open(det_log, "w").close()
        if trk_log:
            open(trk_log, "w").close()
    scan = start_scan
    for f in frames:
        out, hist = proc.stream(f, mti_bypass=mti_bypass,
                                scale_override=scale_override, hist=hist)
        out = jax.tree.map(np.asarray, out)
        scan += 1
        v = out["valid"]
        state_dev = {k: jnp.asarray(val) for k, val in state.items()}
        final, rep = jt.step(state_dev,
                             jnp.asarray(out["range_bin"]),
                             jnp.asarray(out["doppler_bin"]),
                             jnp.asarray(out["mag"].astype(np.int32)),
                             jnp.asarray(v), tp=tp)
        rep = jax.tree.map(np.asarray, rep)
        state = {k: np.asarray(val) for k, val in final.items()}
        _write_scan_logs(det_log, trk_log, out["range_bin"],
                         out["doppler_bin"], out["mag"], v, rep)
        yield ScanResult(scan=scan, n_dets=int(np.sum(v)),
                         active_tracks=int(rep["active_tracks"]),
                         report=rep, tracker_state=state,
                         stream_hist=np.asarray(hist))
