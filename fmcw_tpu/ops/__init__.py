"""JAX compute stages for the radar chain (and one Pallas kernel)."""

from . import window, fft, notch, magnitude, cfar, detect, beamform  # noqa: F401
