"""One place that names the compiled route of every stage of the chain.

Every processor builder (models/pipeline.py, parallel/sharded.py) resolves
its options here and then branches on the returned fields alone, so the
routes a processor reports (``process.routes``) are the routes it runs, and
a single-chip model and the mesh it is parity-tested against cannot take
different routes.  A route that is requested but has no compiled lowering
raises; nothing falls back silently to an interpreter, to another device or
to a reference.

    routes = resolve_routes(fmcw_tpu.full())
    routes.as_dict()
    # {'range_fft': 'matmul', 'slow_time': 'folded',
    #  'magnitude': 'alpha_max_beta_min', 'cfar': 'count'}
"""

from __future__ import annotations

import dataclasses

from .params import RadarParams
from .ops import cfar as C

FFT_ROUTES = ("matmul", "ct", "xla")


@dataclasses.dataclass(frozen=True)
class Routes:
    """The compiled route each stage runs.

    range_fft  matmul (the DFT as one GEMM) | ct (two-stage Cooley-Tukey
               GEMMs) | xla (cuFFT); in fixed mode each is followed by the
               BFP quantizer, or "scaled" (the stage-scaled integer FFT)
    slow_time  folded (corner turn, MTI, window and Doppler DFT as one
               contraction; float mode) | notch_fft (fixed mode: integer
               MTI notch and window, then the range_fft route)
    magnitude  exact | alpha_max_beta_min | fixed
    cfar       count | topk (cfar_2d: ranked stack, or box sums for
               ca/go/so) | hw_stream (counting) | stack3d
    """

    range_fft: str
    slow_time: str
    magnitude: str
    cfar: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def resolve_routes(params: RadarParams | None = None, mode: str = "float32",
                   fft_method: str = "matmul", cfar_method: str = "auto",
                   cfar_geometry: str = "named", include_debug: bool = False,
                   magnitude_exact: bool = False, fixed_fft: str = "bfp",
                   sp: int = 1, ref_angle: int | None = None) -> Routes:
    """Resolve and validate every stage's route.

    ``ref_angle`` is None for the single-channel models and the array
    model's angle extent otherwise (``ref_angle > 0`` takes the stacked 3D
    CFAR).  ``sp`` > 1 is a range-sharded mesh.  Raises ValueError for a
    removed or unknown route and for option combinations no route
    implements."""
    p = params or RadarParams()
    if mode not in ("float32", "fixed"):
        raise ValueError(f"mode must be 'float32' or 'fixed', got {mode!r}")
    if fft_method not in FFT_ROUTES:
        raise ValueError(f"fft_method {fft_method!r} has no compiled route; "
                         f"choose one of {FFT_ROUTES}")
    if cfar_geometry not in ("named", "hw_stream"):
        raise ValueError(f"cfar_geometry must be 'named' or 'hw_stream', "
                         f"got {cfar_geometry!r}")
    if fixed_fft not in ("bfp", "scaled"):
        raise ValueError(f"fixed_fft must be 'bfp' or 'scaled', "
                         f"got {fixed_fft!r}")
    if fixed_fft == "scaled" and mode != "fixed":
        raise ValueError("fixed_fft='scaled' applies to mode='fixed'")

    if mode == "fixed":
        range_fft = "scaled" if fixed_fft == "scaled" else fft_method
        slow_time = "notch_fft"
        magnitude = "fixed"
    else:
        range_fft = fft_method
        slow_time = "folded"
        magnitude = "exact" if magnitude_exact else "alpha_max_beta_min"

    if cfar_geometry == "hw_stream":
        if p.cfar.variant != "os" or p.cfar.scale_mode != "cell":
            raise ValueError(
                "cfar_geometry='hw_stream' reproduces the as-built hardware "
                "detector: per-cell OS variant only (os_cfar_2d.vhd has no "
                "CA/GO/SO or block-scale counterpart)")
        if ref_angle is not None or sp > 1:
            raise ValueError("cfar_geometry='hw_stream' runs on the "
                             "single-channel single-device model only")
        if cfar_method != "auto":
            raise ValueError("cfar_geometry='hw_stream' has one route "
                             "(counting); leave cfar_method='auto'")
        cfar = "hw_stream"
    elif ref_angle:
        if cfar_method not in ("auto", "topk"):
            raise ValueError(f"cfar method {cfar_method!r} has no compiled "
                             f"route for the angle-extended CFAR; choose "
                             f"'auto' or 'topk'")
        cfar = "stack3d"
    else:
        cfar = C.cfar_route(p.cfar, cfar_method, include_debug)
    return Routes(range_fft=range_fft, slow_time=slow_time,
                  magnitude=magnitude, cfar=cfar)
