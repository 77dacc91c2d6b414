"""Block-granular ("clutter-map") adaptive scale — CfarParams.scale_mode.

Framework extension (no VHDL counterpart): the {scale_min, scale_nom,
scale_max} clutter classification coarsens to scale_block x scale_block
tiles, classified from each tile's 3x3-block neighborhood; the OS threshold
decision stays exact per cell.  Parity chain verified here:

    golden numpy (int)  ==  cfar_2d (ranked stack)  ==  cfar_2d_count

plus the counting-form <-> explicit-percentile equivalence, the override
short-circuit (block == cell under a global override), and false-alarm-rate
validation vs the per-cell reference semantics.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fmcw_tpu.params import CfarParams, RadarParams
from fmcw_tpu.golden import fixed_point as fp
from fmcw_tpu.ops import cfar as C

BLOCK = CfarParams(scale_mode="block")


def _int_map(seed, R=128, D=128, peaks=8):
    """Noise map with a few strong point targets and a high-clutter stripe
    so all three scale classes appear."""
    rng = np.random.default_rng(seed)
    m = rng.integers(50, 200, (R, D)).astype(np.int32)
    m[40:72] += rng.integers(800, 1500, (32, D)).astype(np.int32)  # clutter
    for _ in range(peaks):
        r, d = rng.integers(0, R), rng.integers(0, D)
        m[r, d] = 40000
    return m


def test_definition_spot_check():
    """Recompute the documented definition from scratch for random blocks:
    per-block neighborhood mean, cells tested against their own block's
    1.5x/0.5x thresholds, exceedance counts summed over the classified
    block's 3x3 neighborhood."""
    cfar = BLOCK
    m = _int_map(0).astype(np.int64)
    scale = fp.block_scale_map(m, cfar)
    B = cfar.scale_block
    N = 9 * B * B
    rank_idx = min((N * cfar.rank_pct) // 100, N - 1)
    k = N - rank_idx
    Rb, Db = m.shape[0] // B, m.shape[1] // B

    def blk(r, c):
        r, c = r % Rb, c % Db
        return m[r * B:(r + 1) * B, c * B:(c + 1) * B]

    def nb_mean(r, c):
        s = sum(blk(r + i, c + j).sum() for i in (-1, 0, 1)
                for j in (-1, 0, 1))
        return s // N

    rng = np.random.default_rng(1)
    for bi, bj in zip(rng.integers(0, Rb, 32), rng.integers(0, Db, 32)):
        cnt_hi = cnt_lo = 0
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                mu = nb_mean(bi + i, bj + j)   # that block's own threshold
                cells = blk(bi + i, bj + j)
                cnt_hi += int((cells > mu + (mu >> 1)).sum())
                cnt_lo += int((cells >= (mu >> 1)).sum())
        hi = cnt_hi >= k
        lo = cnt_lo < k
        want = cfar.scale_max if hi else (cfar.scale_min if lo
                                          else cfar.scale_nom)
        assert scale[bi * B, bj * B] == want


@pytest.mark.parametrize("edge_mode", ["wrap", "reflect"])
def test_golden_vs_xla_int(edge_mode):
    cfar = CfarParams(scale_mode="block", edge_mode=edge_mode)
    m = _int_map(2)
    det_g, thr_g, scale_g = fp.os_cfar_2d(m, cfar, return_debug=True)
    det_x, thr_x, scale_x = C.cfar_2d(jnp.asarray(m), 0, cfar=cfar,
                                      integer=True)
    np.testing.assert_array_equal(scale_g, np.asarray(scale_x))
    np.testing.assert_array_equal(thr_g, np.asarray(thr_x))
    np.testing.assert_array_equal(det_g, np.asarray(det_x))


def test_count_detect_matches_xla_int():
    m = _int_map(3)
    det_x, _, scale_x = C.cfar_2d(jnp.asarray(m), 0, cfar=BLOCK, integer=True)
    det_p, scale_p = C.cfar_2d_count(jnp.asarray(m), 0, cfar=BLOCK,
                                     integer=True)
    np.testing.assert_array_equal(np.asarray(det_x), np.asarray(det_p))
    np.testing.assert_array_equal(np.asarray(scale_x), np.asarray(scale_p))


def test_count_detect_matches_xla_float():
    m = _int_map(4).astype(np.float32) * 1.37
    det_x, _, scale_x = C.cfar_2d(jnp.asarray(m), 0, cfar=BLOCK,
                                  integer=False)
    det_p, scale_p = C.cfar_2d_count(jnp.asarray(m), 0, cfar=BLOCK,
                                     integer=False)
    np.testing.assert_array_equal(np.asarray(det_x), np.asarray(det_p))
    np.testing.assert_array_equal(np.asarray(scale_x), np.asarray(scale_p))


def test_override_short_circuits_to_cell_semantics():
    """With a non-zero global override the block/cell distinction vanishes:
    outputs must be bit-identical to the per-cell path."""
    m = _int_map(5)
    cell = CfarParams()
    det_c, thr_c, _ = C.cfar_2d(jnp.asarray(m), 5, cfar=cell, integer=True)
    det_b, thr_b, _ = C.cfar_2d(jnp.asarray(m), 5, cfar=BLOCK, integer=True)
    np.testing.assert_array_equal(np.asarray(det_c), np.asarray(det_b))
    np.testing.assert_array_equal(np.asarray(thr_c), np.asarray(thr_b))
    det_p, scale_p = C.cfar_2d_count(jnp.asarray(m), 5, cfar=BLOCK,
                                     integer=True)
    np.testing.assert_array_equal(np.asarray(det_c), np.asarray(det_p))
    assert np.all(np.asarray(scale_p) == 5)


def test_false_alarm_rate_close_to_cell_mode():
    """On homogeneous noise the coarser scale granularity must not blow up
    the false-alarm rate relative to the reference per-cell semantics."""
    rng = np.random.default_rng(6)
    far_cell = far_block = 0
    cells = 0
    for seed in range(4):
        m = rng.integers(50, 200, (256, 128)).astype(np.int32)  # noise only
        det_c, _, _ = C.cfar_2d(jnp.asarray(m), 0, cfar=CfarParams(),
                                integer=True)
        det_b, _, _ = C.cfar_2d(jnp.asarray(m), 0, cfar=BLOCK, integer=True)
        far_cell += int(np.count_nonzero(np.asarray(det_c)))
        far_block += int(np.count_nonzero(np.asarray(det_b)))
        cells += m.size
    assert far_block / cells < 0.01
    assert far_block <= max(2 * far_cell, far_cell + 20)


def test_two_target_frame_detections():
    """The golden two-target frame's targets survive block-mode CFAR through
    the full float pipeline."""
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl

    p = RadarParams(cfar=BLOCK)
    frame = pl.complex_to_iq(reference.two_target_frame(p))
    proc = pl.make_processor(p, mode="float32", include_maps=False)
    out = proc(frame)
    rb = np.asarray(out["range_bin"])[np.asarray(out["valid"])]
    assert any(abs(int(r) - 100) <= 2 for r in rb)
    assert any(abs(int(r) - 500) <= 2 for r in rb)


def test_block_divisibility_error():
    with pytest.raises(ValueError, match="divide"):
        fp.block_scale_map(np.zeros((100, 128), np.int64), BLOCK)
    with pytest.raises(ValueError, match="divide"):
        C.block_scale_map(jnp.zeros((128, 100), jnp.int32), BLOCK, True)


def test_sharded_guard():
    with pytest.raises(ValueError, match="block_scale_map_sharded"):
        C.cfar_2d(jnp.zeros((128 + 12, 128), jnp.int32), 0, cfar=BLOCK,
                  integer=True, prepadded_range=True)


@pytest.mark.parametrize("mode,dp,sp", [("float32", 1, 8), ("fixed", 2, 4)])
def test_sharded_block_mode_matches_single_chip(mode, dp, sp):
    """Block-mode adaptive scale across shards (block-grid halo exchange)
    reproduces the single-chip detection set exactly."""
    from fmcw_tpu import quick
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.parallel import mesh as M, sharded as sh

    q = quick()
    q = q.replace(cfar=dataclasses.replace(q.cfar, scale_mode="block"))
    frames = [reference.two_target_frame(q, seed=s) for s in range(4)]
    batch = np.stack([pl.complex_to_iq(f) for f in frames])

    mesh = M.make_mesh(dp=dp, sp=sp)
    proc = sh.make_sharded_processor(mesh, q, mode=mode, include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = jax.tree.map(
        np.asarray, pl.make_batch_processor(q, mode=mode,
                                            include_maps=True)(batch))
    assert np.array_equal(out["det_map"] > 0, single["det_map"] > 0)
    assert np.array_equal(out["n_dets"], single["n_dets"])
    for i in range(batch.shape[0]):
        v_s, v_r = out["valid"][i], single["valid"][i]
        dets_s = set(zip(out["range_bin"][i][v_s].tolist(),
                         out["doppler_bin"][i][v_s].tolist()))
        dets_r = set(zip(single["range_bin"][i][v_r].tolist(),
                         single["doppler_bin"][i][v_r].tolist()))
        assert dets_s == dets_r
    if mode == "fixed":
        np.testing.assert_array_equal(out["mag_map"], single["mag_map"])


def test_sharded_block_divisibility_guard():
    from fmcw_tpu import quick
    from fmcw_tpu.parallel import mesh as M, sharded as sh

    q = quick()
    q = q.replace(cfar=dataclasses.replace(q.cfar, scale_mode="block",
                                           scale_block=32))
    with pytest.raises(ValueError, match="divisible"):
        sh.make_sharded_processor(M.make_mesh(dp=1, sp=8), q)
