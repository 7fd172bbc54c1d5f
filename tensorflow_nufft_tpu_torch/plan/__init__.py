"""NUFFT planning: tolerance-driven kernel parameters and fine-grid
sizing (numpy only)."""

from tensorflow_nufft_tpu_torch.plan.plan import (
    NufftPlan,
    PlanSpec,
    make_plan,
)

__all__ = ["NufftPlan", "PlanSpec", "make_plan"]
