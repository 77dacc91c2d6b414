"""Device mesh construction for the radar framework.

Two parallel axes (SURVEY.md section 2d):

* ``dp`` — data parallelism over frames (each chip group processes whole
  frames independently; the reference's one-frame-at-a-time hardware scaled
  out);
* ``sp`` — sequence parallelism within a frame: chirps sharded for the range
  FFT, all-to-all corner turn, range bins sharded for the Doppler FFT and
  CFAR (the mesh realization of the ping-pong BRAM corner turner,
  rtl/src/corner_turner.vhd:79-80).

Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh`` (the
runtime does this when JAX_COORDINATOR_ADDRESS is set); the mesh then spans
all hosts' devices.  The mesh is a plain reshape of the device list: on
the GPU every card reaches every other over NVLink at the same rate, so no
topology is assumed.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed from standard env vars if configured."""
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
        return True
    return False


def make_mesh(dp: int | None = None, sp: int | None = None,
              devices=None) -> jax.sharding.Mesh:
    """Build a ('dp', 'sp') mesh.  Defaults: sp = all devices, dp = 1.
    dp * sp must equal the device count."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if sp is None and dp is None:
        dp, sp = 1, n
    elif sp is None:
        sp = n // dp
    elif dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, sp)
    return jax.sharding.Mesh(arr, ("dp", "sp"))
