from .stencil import (BORDER_FOR_ORDER, STENCIL_COEFFS, flops_per_point,
                      heat_step, run_heat, run_heat_roll, stencil_interior)
from .stencil_pipeline import (LAUNCHES, pick_pipeline_tile,
                               run_heat_pipeline, run_heat_pipeline2d,
                               run_heat_pipeline_plain)

__all__ = [
    "BORDER_FOR_ORDER",
    "LAUNCHES",
    "STENCIL_COEFFS",
    "flops_per_point",
    "heat_step",
    "pick_pipeline_tile",
    "run_heat",
    "run_heat_pipeline",
    "run_heat_pipeline2d",
    "run_heat_pipeline_plain",
    "run_heat_roll",
    "stencil_interior",
]
