"""A named grid of torch devices for single-controller sharding.

The port's counterpart of ``jax.sharding.Mesh`` as the JAX package's
``parallel.sharded`` reads it: an array of devices with one name per
axis (``axis_names``) and a name -> size mapping (``shape``). One
process drives every device of the mesh, as JAX's ``shard_map`` does; no
``torch.distributed`` process group is involved.

A device may repeat: ``Mesh(np.array(["cpu"] * 8).reshape(2, 4),
("data", "points"))`` is a (2, 4) mesh of logical shards on the CPU, and
``["cuda:0"] * 8`` the same on one card. There is no default mesh: the
caller names the devices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _mesh_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit CUDA index;
    raises where torch cannot reach it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the mesh names {device}, and torch sees no CUDA device")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"the mesh names cuda:{index}, and torch sees "
            f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


class Mesh:
    """A device mesh: ``devices`` (any nested list or numpy array of
    ``torch.device`` objects or strings) with one name per axis.

    Attributes:
        devices: numpy object array of ``torch.device``.
        axis_names: tuple of the axis names.
        shape: dict axis name -> size, in axis order.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {grid.ndim} axes needs as many axis names, got "
                f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, device in np.ndenumerate(grid):
            self.devices[idx] = _mesh_device(device)
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, coords: Dict[Optional[str], int]) -> torch.device:
        """The device at mesh coordinates ``coords`` (axis name -> index);
        an axis not named there (or a None key) takes index 0: the first
        device along a replicated axis."""
        return self.devices[tuple(coords.get(name, 0)
                                  for name in self.axis_names)]
