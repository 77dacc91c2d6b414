"""fmcw_tpu — an FMCW/pulse-Doppler radar processing framework in JAX.

A JAX/XLA implementation with the capabilities of the reference
FPGA design (Aurellia-Beam/fpga-fmcw-radar-processor): Hamming-windowed range
FFT per chirp, corner turn to slow time, MTI clutter notch, Doppler FFT,
alpha-max-beta-min magnitude, 2D OS-CFAR detection (plus CA/GO/SO variants),
and a track-while-scan alpha-beta tracker — formulated as whole-frame array
programs sharded over device meshes rather than per-sample streaming
hardware.  The accelerator is an NVIDIA GPU; every stage compiles through
XLA, and ``routes.resolve_routes`` names the route of each.

Layout:
  params    — configuration dataclasses (== the reference's VHDL generics)
  golden    — numpy golden models (float64 ideal + bit-faithful fixed point)
  routes    — the one resolver that names each stage's compiled route
  ops       — JAX stages (window, DFT, notch, magnitude, CFAR, detect)
  models    — the pipeline "model" (radar_core equivalent), tracker, scenario
  parallel  — mesh/sharding layer: all-to-all corner turn, CFAR halo exchange
  runtime   — streaming multi-frame execution (double-buffered ingest)
  utils     — golden-file I/O, detection/track log formats, visualization
"""

from . import params  # noqa: F401
from .params import (RadarParams, CfarParams, TrackerParams,  # noqa: F401
                     full, quick, fast)

__version__ = "0.1.0"
