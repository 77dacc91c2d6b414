"""TWS alpha-beta tracker (JAX) — jittable, bit-exact vs the golden model.

Array reformulation of the rtl/src/tws_tracker.vhd scan FSM:

* PREDICT/UPDATE become vectorized integer array ops over the 32-track file;
* the sequential nearest-neighbor ASSOCIATE loop (earlier tracks claim
  detections first, tws_tracker.vhd:159-231) is a ``lax.scan`` over track
  index carrying the claimed-detection mask;
* INITIATE's "first free slot" allocation (tws_tracker.vhd:233-263) is a
  rank-match: the k-th unassociated detection (stream order) takes the k-th
  free slot (index order) — identical to the sequential search;
* fields wrap at the VHDL register widths via masked two's-complement.

The tracker state is a pytree of int32 arrays, so it rides inside jitted
multi-scan loops (``lax.scan`` over scans) and stays on device beside the
frame pipeline.  It runs at scan rate (~Hz) — negligible cost next to the
frame pipeline, but keeping it on device avoids a host sync per scan.

Detections arrive as fixed-capacity arrays with a validity mask (the output
of ops/detect.topk_detections), matching the 64-entry buffer cap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..params import TrackerParams
from ..golden.tracker import FREE, TENTATIVE, FIRM, COAST


def _wrap(v, bits):
    m = 1 << bits
    half = m >> 1
    return ((v + half) & (m - 1)) - half


def _wrapu(v, bits):
    return v & ((1 << bits) - 1)


def init_state(tp: TrackerParams | None = None) -> dict:
    tp = tp or TrackerParams()
    z = jnp.zeros(tp.max_tracks, dtype=jnp.int32)
    return {"active": z, "status": z, "range_pos": z, "dopp_pos": z,
            "range_vel": z, "dopp_vel": z, "hit_count": z, "miss_count": z,
            "quality": z, "age": z, "last_mag": z,
            "assoc_best": jnp.full(1, (1 << 16) - 1, dtype=jnp.int32)}


@functools.partial(jax.jit, static_argnames=("tp",))
def step(state: dict, det_range: jnp.ndarray, det_doppler: jnp.ndarray,
         det_mag: jnp.ndarray, det_valid: jnp.ndarray,
         tp: TrackerParams = TrackerParams()):
    """One scan update.  Detection arrays have static length <= max_dets.
    Returns (new_state, report) with report carrying per-slot arrays plus a
    ``report_mask`` (firm/coast emissions) and ``active_tracks``."""
    s = {k: v.astype(jnp.int32) for k, v in state.items()}
    n = tp.max_tracks

    # The hardware's detection buffer holds max_dets entries
    # (radar_core.vhd:15): longer arrays are truncated exactly like
    # golden.tracker.step's [:max_dets] slice — without this, extra
    # detections would initiate tracks the golden model never sees and the
    # bit-exactness contract would silently break.
    dr = det_range[: tp.max_dets].astype(jnp.int32)
    dd = det_doppler[: tp.max_dets].astype(jnp.int32)
    dm = det_mag[: tp.max_dets].astype(jnp.int32)
    dv = det_valid[: tp.max_dets]
    meas_r = _wrap(dr << 2, 12)
    meas_d = _wrap(dd << 2, 9)

    # PREDICT.
    act = s["active"] == 1
    s["range_pos"] = jnp.where(act, _wrap(s["range_pos"] + s["range_vel"], 12),
                               s["range_pos"])
    s["dopp_pos"] = jnp.where(act, _wrap(s["dopp_pos"] + s["dopp_vel"], 9),
                              s["dopp_pos"])
    s["age"] = jnp.where(act, _wrapu(s["age"] + 1, 8), s["age"])

    # ASSOCIATE + UPDATE: lax.scan over track index, carrying claimed mask.
    def assoc_body(carry, ti):
        st, claimed = carry
        active = st["active"][ti] == 1
        dist_r = jnp.abs(st["range_pos"][ti] - meas_r)
        dist_d = jnp.abs(st["dopp_pos"][ti] - meas_d)
        in_gate = (dv & ~claimed & (dist_r < tp.assoc_gate_r * 4)
                   & (dist_d < tp.assoc_gate_d * 4))
        dist = jnp.where(in_gate, dist_r + dist_d, (1 << 16) - 1)
        if tp.assoc == "hw":
            # VHDL signal semantics (tws_tracker.vhd:159-178): candidates
            # compare against the stale best carried from the previous
            # active track; the last qualifying detection index wins.
            stale = st["assoc_best"][0]
            qual = in_gate & (dist < stale)
            any_q = jnp.any(qual)
            best_i = jnp.max(jnp.where(qual, jnp.arange(dv.shape[0]), -1))
            best_i = jnp.maximum(best_i, 0)
            best_d = jnp.where(any_q, dist[best_i], (1 << 16) - 1)
            found = active & any_q
            st = dict(st)
            st["assoc_best"] = jnp.where(active,
                                         st["assoc_best"].at[0].set(best_d),
                                         st["assoc_best"])
        else:
            best_i = jnp.argmin(dist)      # first minimum wins ties
            best_d = dist[best_i]
            found = active & (best_d < (1 << 16) - 1)

        innov_r = _wrap(meas_r[best_i] - st["range_pos"][ti], 12)
        innov_d = _wrap(meas_d[best_i] - st["dopp_pos"][ti], 9)
        old_hits = st["hit_count"][ti]
        old_miss = st["miss_count"][ti]
        status = st["status"][ti]

        def upd(field, hit_val, miss_val):
            cur = st[field][ti]
            return st[field].at[ti].set(
                jnp.where(found, hit_val,
                          jnp.where(active, miss_val, cur)))

        hit_status = jnp.where(
            (status == TENTATIVE) & (old_hits >= tp.init_hits), FIRM,
            jnp.where(status == COAST, FIRM, status))
        miss_status = jnp.where(old_miss >= tp.coast_max, FREE,
                                jnp.where(status == FIRM, COAST, status))

        st = dict(st)
        st["range_pos"] = upd("range_pos",
                              _wrap(st["range_pos"][ti] +
                                    ((innov_r * tp.alpha_gain) >> 8), 12),
                              st["range_pos"][ti])
        st["dopp_pos"] = upd("dopp_pos",
                             _wrap(st["dopp_pos"][ti] +
                                   ((innov_d * tp.alpha_gain) >> 8), 9),
                             st["dopp_pos"][ti])
        st["range_vel"] = upd("range_vel",
                              _wrap(st["range_vel"][ti] +
                                    ((innov_r * tp.beta_gain) >> 8), 10),
                              st["range_vel"][ti])
        st["dopp_vel"] = upd("dopp_vel",
                             _wrap(st["dopp_vel"][ti] +
                                   ((innov_d * tp.beta_gain) >> 8), 8),
                             st["dopp_vel"][ti])
        st["hit_count"] = upd("hit_count", _wrapu(old_hits + 1, 4), old_hits)
        st["miss_count"] = upd("miss_count", 0, _wrapu(old_miss + 1, 4))
        st["last_mag"] = upd("last_mag", dm[best_i], st["last_mag"][ti])
        st["status"] = upd("status", hit_status, miss_status)
        st["active"] = upd("active", st["active"][ti],
                           jnp.where(old_miss >= tp.coast_max, 0,
                                     st["active"][ti]))
        st["quality"] = upd("quality",
                            jnp.minimum(st["quality"][ti] + 1, 15),
                            jnp.maximum(st["quality"][ti] - 1, 0))
        claimed = claimed | (jnp.arange(dv.shape[0]) == best_i) & found
        return (st, claimed), None

    (s, claimed), _ = jax.lax.scan(assoc_body, (s, jnp.zeros_like(dv)),
                                   jnp.arange(n))

    # INITIATE: k-th unassociated detection -> k-th free slot.
    candidate = dv & ~claimed
    inactive = s["active"] == 0
    k_pairs = min(n, dv.shape[0])
    free_order = jnp.argsort((~inactive).astype(jnp.int32), stable=True)
    det_order = jnp.argsort((~candidate).astype(jnp.int32), stable=True)
    n_free = jnp.sum(inactive)
    n_cand = jnp.sum(candidate)
    k = jnp.arange(k_pairs)
    pair_ok = (k < n_free) & (k < n_cand)
    slots = free_order[:k_pairs]
    dets = det_order[:k_pairs]

    def scatter(field, newvals):
        cur = s[field][slots]
        return s[field].at[slots].set(jnp.where(pair_ok, newvals, cur))

    s["active"] = scatter("active", jnp.ones_like(slots))
    s["status"] = scatter("status", jnp.full_like(slots, TENTATIVE))
    s["range_pos"] = scatter("range_pos", meas_r[dets])
    s["dopp_pos"] = scatter("dopp_pos", meas_d[dets])
    s["range_vel"] = scatter("range_vel", jnp.zeros_like(slots))
    s["dopp_vel"] = scatter("dopp_vel", jnp.zeros_like(slots))
    s["hit_count"] = scatter("hit_count", jnp.ones_like(slots))
    s["miss_count"] = scatter("miss_count", jnp.zeros_like(slots))
    s["quality"] = scatter("quality", jnp.ones_like(slots))
    s["age"] = scatter("age", jnp.zeros_like(slots))
    s["last_mag"] = scatter("last_mag", dm[dets])

    # MAINTAIN + OUTPUT.
    report_mask = (s["active"] == 1) & ((s["status"] == FIRM) |
                                        (s["status"] == COAST))
    report = {"id": jnp.arange(n, dtype=jnp.int32),
              "range_pos": s["range_pos"], "dopp_pos": s["dopp_pos"],
              "range_vel": s["range_vel"], "dopp_vel": s["dopp_vel"],
              "quality": s["quality"], "status": s["status"],
              "report_mask": report_mask,
              "active_tracks": jnp.sum(s["active"] == 1).astype(jnp.int32)}
    return s, report


@functools.partial(jax.jit, static_argnames=("tp",))
def _run_scans(state, dr, dd, dm, dv, tp: TrackerParams):
    def body(st, xs):
        st2, rep = step(st, *xs, tp=tp)
        return st2, rep
    return jax.lax.scan(body, state, (dr, dd, dm, dv))


def run_scans(det_range, det_doppler, det_mag, det_valid,
              tp: TrackerParams | None = None, state: dict | None = None):
    """Process a whole batch of scans on device: inputs are (n_scans, K)
    arrays; returns (final_state, stacked reports) via lax.scan.  The jitted
    scan is module-level (static ``tp``) so repeated calls — e.g. one per
    ingest batch in a surveillance loop — reuse one compiled executable."""
    tp = tp or TrackerParams()
    state = state or init_state(tp)
    return _run_scans(state, det_range, det_doppler, det_mag, det_valid,
                      tp=tp)
