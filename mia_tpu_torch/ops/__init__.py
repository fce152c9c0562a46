from .distance import binary_border, pairwise_distances, squared_edt, surface_distance_stats
from .filters import gaussian_blur, simulate_low_res
from .morphology import (
    dilate,
    erode,
    fill_hole,
    gaussian_blur_threshold_smooth,
    remove_cc,
    remove_small_regions,
)
from .upsample2x import conv_transpose2x, conv_transpose2x_plain
from .warp import (
    affine_inverse_matrix,
    affine_warp,
    affine_warp_shift2pass,
    affine_warp_shift2pass_fused,
    rotate_warp,
)

__all__ = [
    "affine_inverse_matrix",
    "affine_warp",
    "affine_warp_shift2pass",
    "affine_warp_shift2pass_fused",
    "binary_border",
    "conv_transpose2x",
    "conv_transpose2x_plain",
    "dilate",
    "erode",
    "fill_hole",
    "gaussian_blur",
    "gaussian_blur_threshold_smooth",
    "pairwise_distances",
    "remove_cc",
    "remove_small_regions",
    "rotate_warp",
    "simulate_low_res",
    "squared_edt",
    "surface_distance_stats",
]
