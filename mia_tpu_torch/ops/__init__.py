from .distance import binary_border, squared_edt, surface_distance_stats
from .filters import gaussian_blur, simulate_low_res
from .warp import (
    affine_inverse_matrix,
    affine_warp_shift2pass,
    affine_warp_shift2pass_fused,
)

__all__ = [
    "affine_inverse_matrix",
    "affine_warp_shift2pass",
    "affine_warp_shift2pass_fused",
    "binary_border",
    "gaussian_blur",
    "simulate_low_res",
    "squared_edt",
    "surface_distance_stats",
]
