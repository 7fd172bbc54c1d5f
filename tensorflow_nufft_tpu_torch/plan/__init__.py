"""NUFFT planning: tolerance-driven kernel parameters and fine-grid
sizing (numpy only)."""

from tensorflow_nufft_tpu_torch.plan.plan import (
    NufftPlan,
    PlanSpec,
    make_plan,
    select_upsampling_factor,
    select_kernel_width,
    kernel_beta,
    kernel_fseries_1d,
    calculate_scale_factor,
    MAX_KERNEL_WIDTH,
    EPSILON,
)

__all__ = [
    "NufftPlan",
    "PlanSpec",
    "make_plan",
    "select_upsampling_factor",
    "select_kernel_width",
    "kernel_beta",
    "kernel_fseries_1d",
    "calculate_scale_factor",
    "MAX_KERNEL_WIDTH",
    "EPSILON",
]
