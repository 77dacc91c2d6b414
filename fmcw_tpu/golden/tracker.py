"""Bit-faithful TWS alpha-beta tracker golden model (pure numpy).

Reproduces rtl/src/tws_tracker.vhd exactly, including VHDL signal-update
subtleties:

* status/drop decisions read the *pre-increment* hit/miss counters
  (tws_tracker.vhd:203-224): a tentative track confirms on its 3rd hit
  (INIT_HITS=2 compares the old count), a track drops on its 6th consecutive
  miss (COAST_MAX=5 compares the old count).
* association is sequential in track order — earlier tracks claim detections
  first (ASSOCIATE/UPDATE loop, tws_tracker.vhd:159-231); nearest neighbor by
  L1 distance in Q2 units, gate +-ASSOC_GATE_R/D bins, first detection wins
  ties (strict '<' comparison).
* all fields wrap at their VHDL bit widths (positions Q2 signed 12/9 bits,
  velocities 10/8 bits, counters 4 bits, age 8 bits).
* initiation assigns unassociated detections (in stream order) to the lowest
  free track slots (tws_tracker.vhd:233-263).

State is a dict of numpy arrays (a pytree), advanced one scan at a time by
``step`` — the JAX tracker (models/tracker.py) matches it bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..params import TrackerParams

FREE, TENTATIVE, FIRM, COAST = 0, 1, 2, 3


def _wrap(v, bits):
    """Two's-complement wrap to ``bits``-bit signed."""
    m = 1 << bits
    return ((np.asarray(v) + (m >> 1)) % m) - (m >> 1)


def _wrapu(v, bits):
    return np.asarray(v) % (1 << bits)


def init_state(tp: TrackerParams | None = None) -> dict:
    tp = tp or TrackerParams()
    n = tp.max_tracks
    z = lambda: np.zeros(n, dtype=np.int64)
    return {"active": z(), "status": z(), "range_pos": z(), "dopp_pos": z(),
            "range_vel": z(), "dopp_vel": z(), "hit_count": z(),
            "miss_count": z(), "quality": z(), "age": z(), "last_mag": z(),
            # The VHDL best_distance signal (tws_tracker.vhd:84) carried
            # across tracks/scans — used only by assoc="hw".
            "assoc_best": np.full(1, (1 << 16) - 1, dtype=np.int64)}


def step(state: dict, det_range, det_doppler, det_mag,
         tp: TrackerParams | None = None) -> tuple[dict, dict]:
    """Advance the track file by one scan.

    Detections are given in stream order; only the first ``max_dets`` are
    used (the 64-entry buffer cap, tws_tracker.vhd:66,131-139).  Returns
    (new_state, report) where report contains the OUTPUT-state track emissions
    (firm/coast tracks) and active count.
    """
    tp = tp or TrackerParams()
    s = {k: v.copy() for k, v in state.items()}
    n = tp.max_tracks

    dr = np.asarray(det_range, dtype=np.int64)[: tp.max_dets]
    dd = np.asarray(det_doppler, dtype=np.int64)[: tp.max_dets]
    dm = np.asarray(det_mag, dtype=np.int64)[: tp.max_dets]
    ndet = len(dr)
    associated = np.zeros(ndet, dtype=bool)

    # PREDICT (tws_tracker.vhd:144-157): pos += vel, age += 1.
    act = s["active"] == 1
    s["range_pos"] = np.where(act, _wrap(s["range_pos"] + s["range_vel"], 12),
                              s["range_pos"])
    s["dopp_pos"] = np.where(act, _wrap(s["dopp_pos"] + s["dopp_vel"], 9),
                             s["dopp_pos"])
    s["age"] = np.where(act, _wrapu(s["age"] + 1, 8), s["age"])

    # ASSOCIATE + UPDATE, sequential per track (tws_tracker.vhd:159-231).
    for ti in range(n):
        if s["active"][ti] != 1:
            continue
        # Measurements are Q2 positions wrapped at the VHDL register widths
        # (tws_tracker.vhd:166-169,188-189): range bins >= 512 and Doppler
        # bins >= 64 wrap negative — consistently in association, update and
        # initiation, so tracking is unaffected but reported positions are
        # two's-complement (Doppler >= 64 reads as negative Doppler).
        best_d, best_i = (1 << 16) - 1, -1
        hw_stale = int(s["assoc_best"][0])  # assoc="hw": previous track's best
        for d in range(ndet):
            if associated[d]:
                continue
            dist_r = abs(int(s["range_pos"][ti]) - int(_wrap(int(dr[d]) << 2, 12)))
            dist_d = abs(int(s["dopp_pos"][ti]) - int(_wrap(int(dd[d]) << 2, 9)))
            if dist_r < tp.assoc_gate_r * 4 and dist_d < tp.assoc_gate_d * 4:
                dist = dist_r + dist_d
                if tp.assoc == "hw":
                    # VHDL signal semantics: every candidate compares against
                    # the stale pre-cycle best; the last qualifying
                    # assignment wins (tws_tracker.vhd:159-178).
                    if dist < hw_stale:
                        best_d, best_i = dist, d
                elif dist < best_d:
                    best_d, best_i = dist, d
        if tp.assoc == "hw":
            s["assoc_best"][0] = best_d  # committed for the next active track
        if best_i >= 0:
            associated[best_i] = True
            meas_r = int(_wrap(int(dr[best_i]) << 2, 12))
            meas_d = int(_wrap(int(dd[best_i]) << 2, 9))
            innov_r = _wrap(meas_r - s["range_pos"][ti], 12)
            innov_d = _wrap(meas_d - s["dopp_pos"][ti], 9)
            s["range_pos"][ti] = _wrap(s["range_pos"][ti] +
                                       (innov_r * tp.alpha_gain >> 8), 12)
            s["dopp_pos"][ti] = _wrap(s["dopp_pos"][ti] +
                                      (innov_d * tp.alpha_gain >> 8), 9)
            s["range_vel"][ti] = _wrap(s["range_vel"][ti] +
                                       (innov_r * tp.beta_gain >> 8), 10)
            s["dopp_vel"][ti] = _wrap(s["dopp_vel"][ti] +
                                      (innov_d * tp.beta_gain >> 8), 8)
            old_hits = s["hit_count"][ti]
            s["hit_count"][ti] = _wrapu(old_hits + 1, 4)
            s["miss_count"][ti] = 0
            s["last_mag"][ti] = dm[best_i]
            if s["status"][ti] == TENTATIVE and old_hits >= tp.init_hits:
                s["status"][ti] = FIRM
            elif s["status"][ti] == COAST:
                s["status"][ti] = FIRM
            if s["quality"][ti] < 15:
                s["quality"][ti] += 1
        else:
            old_miss = s["miss_count"][ti]
            s["miss_count"][ti] = _wrapu(old_miss + 1, 4)
            if s["status"][ti] == FIRM:
                s["status"][ti] = COAST
            if old_miss >= tp.coast_max:
                s["active"][ti] = 0
                s["status"][ti] = FREE
            if s["quality"][ti] > 0:
                s["quality"][ti] -= 1

    # INITIATE (tws_tracker.vhd:233-263): unassociated dets -> lowest free slots.
    for d in range(ndet):
        if associated[d]:
            continue
        free = np.nonzero(s["active"] == 0)[0]
        if len(free) == 0:
            continue
        ti = free[0]
        s["active"][ti] = 1
        s["status"][ti] = TENTATIVE
        s["range_pos"][ti] = _wrap(int(dr[d]) << 2, 12)
        s["dopp_pos"][ti] = _wrap(int(dd[d]) << 2, 9)
        s["range_vel"][ti] = 0
        s["dopp_vel"][ti] = 0
        s["hit_count"][ti] = 1
        s["miss_count"][ti] = 0
        s["quality"][ti] = 1
        s["age"][ti] = 0
        s["last_mag"][ti] = dm[d]

    # MAINTAIN + OUTPUT (tws_tracker.vhd:265-295).
    active_count = int(np.sum(s["active"] == 1))
    report_mask = (s["active"] == 1) & ((s["status"] == FIRM) |
                                        (s["status"] == COAST))
    report = {
        "id": np.nonzero(report_mask)[0],
        "range_pos": s["range_pos"][report_mask],
        "dopp_pos": s["dopp_pos"][report_mask],
        "range_vel": s["range_vel"][report_mask],
        "dopp_vel": s["dopp_vel"][report_mask],
        "quality": s["quality"][report_mask],
        "status": s["status"][report_mask],
        "active_tracks": active_count,
    }
    return s, report
