"""1-D device meshes for laying a sweep's lanes over several devices (port
of the grid half of ``repro.common.sharding``).

A port mesh is a ``GridMesh``: a tuple of ``torch.device``s along one axis
named ``GRID_AXIS``.  ``SweepRunner(mesh=...)`` gives mesh position d the
round-robin lanes {d, d + n, ...} of each chunk and runs that block of
lanes as one batched loop on its device (``repro_torch.core.sweep``).

The device list may repeat a device: ``grid_mesh(2, devices=["cuda:0",
"cuda:0"])`` lays lanes over "two devices" that are one card, and
``grid_mesh(2, devices=["cpu", "cpu"])`` over the CPU.  It is the port's
stand-in for the reference's emulated host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), and a testing
layout, not a speed-up: the blocks of a repeated device run one after
another.

The logical-axis half of the reference module (``MeshRules``,
``DEFAULT_RULES``, ``shard_tree``) comes with the launch mesh
(``launch/mesh.py``).
"""
from __future__ import annotations

import dataclasses

import torch

GRID_AXIS = "grid"


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A 1-D mesh: ``devices[d]`` is mesh position d (a device may
    appear more than once) along the axis ``axis``."""
    devices: tuple
    axis: str = GRID_AXIS

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def _visible_devices() -> list:
    """Every CUDA device this process sees (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_mesh(n_devices: int | None = None, axis: str = GRID_AXIS,
              devices=None) -> GridMesh | None:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default:
    every visible CUDA device) for laying out a sweep's lanes.

    Returns ``None`` when fewer than two devices are asked for (callers
    then run every lane on one device); raises ``ValueError`` when more
    are asked for than ``devices`` holds."""
    devices = list(devices if devices is not None else _visible_devices())
    n = len(devices) if n_devices is None else int(n_devices)
    if n > len(devices):
        raise ValueError(f"grid_mesh wants {n} devices but only "
                         f"{len(devices)} are available")
    if n < 2:
        return None
    return GridMesh(tuple(devices[:n]), axis)


def resolve_grid_mesh(mesh, axis: str = GRID_AXIS) -> GridMesh | None:
    """Normalize a user-facing mesh argument to a ``GridMesh`` or ``None``.

    Accepts ``None`` (one device), ``"auto"`` (every visible CUDA device,
    or ``None`` when only one is visible), an int device count, or a
    prebuilt ``GridMesh`` (``None`` when it holds one device)."""
    if mesh is None:
        return None
    if isinstance(mesh, GridMesh):
        return mesh if _mesh_size(mesh) > 1 else None
    if isinstance(mesh, str) and mesh == "auto":
        return grid_mesh(axis=axis)
    if isinstance(mesh, int):
        return grid_mesh(mesh, axis=axis)
    raise TypeError(f"mesh must be None, 'auto', an int device count or a "
                    f"GridMesh; got {type(mesh).__name__}")


def _mesh_size(mesh: GridMesh) -> int:
    return mesh.size
