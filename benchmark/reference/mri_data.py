"""The benchmark's own MRI data: a radial trajectory, its ramp density,
birdcage-like coil maps and a phantom, made on the device in float64 and
handed to both sides in the precision the configuration states."""

from __future__ import annotations

import math

import torch


def radial_trajectory(spokes: int, samples: int, device) -> torch.Tensor:
    """[spokes * samples, 2] float64 points in radians per pixel: spokes
    at angles pi s / spokes, ``samples`` readout points spaced 2 pi /
    samples on [-pi, pi) (twofold readout oversampling where samples is
    twice the matrix)."""
    angles = torch.arange(spokes, dtype=torch.float64,
                          device=device) * (math.pi / spokes)
    radii = (torch.arange(samples, dtype=torch.float64, device=device)
             - samples / 2) * (2 * math.pi / samples)
    kx = radii[None, :] * torch.cos(angles)[:, None]
    ky = radii[None, :] * torch.sin(angles)[:, None]
    return torch.stack([kx.reshape(-1), ky.reshape(-1)], dim=-1)


def ramp_density(spokes: int, samples: int, device) -> torch.Tensor:
    """[spokes * samples] float64 ramp (|k|) density compensation, the
    centre sample given the width of one readout step, normalised to sum
    to 1."""
    radii = torch.abs(torch.arange(samples, dtype=torch.float64,
                                   device=device) - samples / 2)
    radii = torch.clamp(radii, min=0.5)
    w = radii.repeat(spokes)
    return w / w.sum()


def coil_maps(coils: int, grid, device) -> torch.Tensor:
    """[coils, n0, n1] complex128 maps: a Gaussian sensitivity around
    each of ``coils`` centres on a ring, with the coil's phase, scaled so
    that the root sum of squares is 1."""
    n0, n1 = grid
    y = (torch.arange(n0, dtype=torch.float64, device=device)
         / n0 - 0.5)[:, None]
    x = (torch.arange(n1, dtype=torch.float64, device=device)
         / n1 - 0.5)[None, :]
    maps = []
    for c in range(coils):
        ang = 2 * math.pi * c / coils
        r2 = (y - 0.45 * math.sin(ang)) ** 2 + (x - 0.45 * math.cos(ang)) ** 2
        mag = torch.exp(-4.0 * r2)
        maps.append(torch.polar(mag, torch.full_like(mag, ang)))
    maps = torch.stack(maps)
    sos = torch.sqrt(torch.sum(torch.abs(maps) ** 2, dim=0))
    return maps / sos


# (centre y, centre x, semi-axis along u, semi-axis along v, angle of u
# from the x axis in degrees, intensity): ten ellipses after the
# modified Shepp-Logan head.
_ELLIPSES = (
    (0.0, 0.0, 0.92, 0.69, 90.0, 1.0),
    (-0.0184, 0.0, 0.874, 0.6624, 90.0, -0.8),
    (0.0, 0.22, 0.31, 0.11, 72.0, -0.2),
    (0.0, -0.22, 0.41, 0.16, 108.0, -0.2),
    (0.35, 0.0, 0.25, 0.21, 90.0, 0.1),
    (0.1, 0.0, 0.046, 0.046, 0.0, 0.1),
    (-0.1, 0.0, 0.046, 0.046, 0.0, 0.1),
    (-0.605, -0.08, 0.046, 0.023, 0.0, 0.1),
    (-0.605, 0.0, 0.023, 0.023, 0.0, 0.1),
    (-0.605, 0.06, 0.046, 0.023, 90.0, 0.1),
)


def phantom(grid, device) -> torch.Tensor:
    """[n0, n1] complex128 modified Shepp-Logan phantom (real values)."""
    n0, n1 = grid
    y = (torch.arange(n0, dtype=torch.float64, device=device)
         - n0 / 2)[:, None] / (n0 / 2)
    x = (torch.arange(n1, dtype=torch.float64, device=device)
         - n1 / 2)[None, :] / (n1 / 2)
    img = torch.zeros(n0, n1, dtype=torch.float64, device=device)
    for cy, cx, ay, ax, deg, val in _ELLIPSES:
        t = math.radians(deg)
        u = (x - cx) * math.cos(t) + (y - cy) * math.sin(t)
        v = -(x - cx) * math.sin(t) + (y - cy) * math.cos(t)
        img = img + val * ((u / ay) ** 2 + (v / ax) ** 2 <= 1.0)
    return img.to(torch.complex128)
