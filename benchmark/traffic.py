"""The general traffic generator: every input of a run, made from the
seed on the run's device in a few large calls, from the parameters of a
configuration file and a traffic file.

Points (``config["points"]``):

- ``{"kind": "uniform", "count": M}``: M points uniform in [-pi, pi)^d,
  d = len(config["modes"]);
- ``{"kind": "radial", "spokes": S, "samples": R}``: the radial
  trajectory of ``reference.mri_data`` (no randomness).

Requests cycle through a pool of ``traffic["pool"]`` seeded inputs:
request i takes pool entry i mod pool, so every seed gives the same sizes
and the same arrivals (a closed loop of one client), with other values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import mri_data


class Inputs:
    """Seeded maker of a run's inputs on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.rng = np.random.default_rng(int(seed))

    def uniform(self, shape, low: float, high: float,
                dtype=torch.float32) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float64)
        return (low + (high - low) * u).to(dtype)

    def normal(self, shape, std: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
        return std * torch.randn(shape, generator=self.gen,
                                 device=self.device, dtype=dtype)

    def sample(self, population: int, count: int) -> torch.Tensor:
        """``count`` distinct sorted indices below ``population``."""
        idx = np.sort(self.rng.choice(population, min(count, population),
                                      replace=False))
        return torch.from_numpy(idx).to(self.device)


def points(config: dict, inputs: Inputs) -> torch.Tensor:
    """The configuration's points, [M, d] float32 on the run's device."""
    spec = config["points"]
    if spec["kind"] == "uniform":
        return inputs.uniform((spec["count"], len(config["modes"])),
                              -math.pi, math.pi)
    if spec["kind"] == "radial":
        return mri_data.radial_trajectory(
            spec["spokes"], spec["samples"], inputs.device).float()
    raise ValueError(f"unknown points kind {spec['kind']!r}")


def wrap(points: torch.Tensor) -> torch.Tensor:
    """Points taken back into [-pi, pi)."""
    return torch.remainder(points + math.pi, 2 * math.pi) - math.pi
