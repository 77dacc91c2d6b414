"""Schema test for the committed CPU-mesh bench_scaling artifact.

docs/bench_scaling_cpu.json is a checked-in example of the weak-scaling
record (BASELINE configs 3/5): it pins the JSON schema, the efficiency
math, and the northstar pass/fail mechanics so the first run on a real
multi-chip slice is purely environmental — same command, same record
shape, only the hardware changes (tools/bench_scaling.py header).
"""

import json
import os

import pytest

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "bench_scaling_cpu.json")


@pytest.fixture(scope="module")
def record():
    with open(ART) as f:
        return json.load(f)


def test_artifact_schema(record):
    assert set(record) == {"results", "northstar"}
    assert record["results"], "at least one mesh measured"
    for r in record["results"]:
        assert set(r) == {"config", "chips", "fps", "weak_scaling_eff"}
        axis, n = r["config"].split("=")
        assert axis in ("dp", "sp")
        assert int(n) == r["chips"] >= 1
        assert r["fps"] > 0
    ns = record["northstar"]
    assert set(ns) == {"target_eff", "measured_eff", "at", "hardware",
                       "meaningful", "pass"}
    assert ns["target_eff"] == 0.90


def test_efficiency_math(record):
    """weak_scaling_eff = fps(n) / (n * fps(dp=1)) to the artifact's
    rounding (3 decimals on eff, 1 on fps)."""
    base = record["results"][0]
    assert base["config"] == "dp=1" and base["chips"] == 1
    for r in record["results"]:
        want = r["fps"] / (r["chips"] * base["fps"])
        assert abs(r["weak_scaling_eff"] - want) < 5e-3, r


def test_northstar_semantics(record):
    """The northstar is evaluated on the largest dp mesh; pass iff measured
    >= target; 'meaningful' is False off real multi-GPU hardware (the
    CPU virtual devices share host cores, so efficiency collapse there is
    expected and non-probative)."""
    ns = record["northstar"]
    dp = [r for r in record["results"] if r["config"].startswith("dp=")]
    biggest = max(dp, key=lambda r: r["chips"])
    assert ns["at"] == biggest["config"]
    assert ns["measured_eff"] == biggest["weak_scaling_eff"]
    assert ns["pass"] == (ns["measured_eff"] >= ns["target_eff"])
    if ns["hardware"] == "cpu":
        assert ns["meaningful"] is False
