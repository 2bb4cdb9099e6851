"""Device meshes: logical-axis sharding rules (port of
``repro.common.sharding``) and 1-D grid meshes for a sweep's lanes.

**Logical axes.**  A parameter or activation names each dim by a logical
axis; ``MeshRules`` maps the logical axes to mesh axes (the reference's
``DEFAULT_RULES``, ``FSDP_RULES``, shape-aware divisibility fallback, no
mesh axis used twice in a spec, mesh axes the mesh lacks dropped) and
gives a ``PartitionSpec``, entry for entry the reference's.

The port runs one process per mesh position (multi-controller SPMD).  A
``Mesh`` has axis names and sizes; it is *abstract* (no processes: specs
only, the reference's ``AbstractMesh``) or *live*: this process's mesh
position ``rank``, its coordinates (row-major, as ``jax.make_mesh`` lays
out host devices) and one process group per set of axes, built by
``repro_torch.launch.mesh``.  A live rank holds only its own shard of
each array: ``local_shard(x, spec, mesh)`` cuts it from the whole array,
``gather_full(x_local, spec, mesh)`` puts the whole array back (every
rank of the mesh calls it), the counterparts of ``device_put`` onto a
``NamedSharding`` and of reading the global array.  A dim sharded over
the axes (a, b) is cut into size(a) * size(b) blocks, block
``index(a) * size(b) + index(b)`` on this rank, as GSPMD cuts it.

Collectives over a mesh's axes go through ``repro_torch.common.comm``.

**Grid meshes.**  A ``GridMesh`` is a tuple of ``torch.device``s along
one axis named ``GRID_AXIS``.  ``SweepRunner(mesh=...)`` gives mesh
position d the round-robin lanes {d, d + n, ...} of each chunk and runs
that block of lanes as one batched loop on its device
(``repro_torch.core.sweep``).  The device list may repeat a device:
``grid_mesh(2, devices=["cuda:0", "cuda:0"])`` lays lanes over "two
devices" that are one card, and ``grid_mesh(2, devices=["cpu", "cpu"])``
over the CPU: the port's stand-in for the reference's emulated host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``), a
testing layout, not a speed-up.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# ---------------------------------------------------------------------------
# logical axes -> mesh axes
# ---------------------------------------------------------------------------

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": ("data",),
    "vocab": ("model",),
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "mla_latent": ("model",),
    "layers": None,
    "conv": None,
    "state": None,
}

# FSDP variant: additionally shard the d_model dim of weights over "data"
FSDP_RULES = dict(DEFAULT_RULES, embed=("data",))

BATCH_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (not sharded), a mesh axis name, or a
    tuple of them; a tuple that compares equal, entry by entry, to the
    reference's ``jax.sharding.PartitionSpec`` once converted (trailing
    ``None``s are kept as given; ``MeshRules.pspec`` strips them, as the
    reference's does)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"

    def axes(self, dim: int) -> tuple:
        """The mesh axes dim ``dim`` is sharded over (empty: none)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)

    def used_axes(self) -> tuple:
        """Every mesh axis the spec names, in order."""
        return tuple(a for i in range(len(self)) for a in self.axes(i))


P = PartitionSpec


class Mesh:
    """A mesh of ``axis_names`` with sizes ``shape`` (a dict, the
    reference's ``mesh.shape``).  Abstract unless built live by
    ``repro_torch.launch.mesh`` (``rank`` is then this process's mesh
    position, ``device`` its device, ``backend`` the transport of its
    groups)."""

    def __init__(self, sizes, axis_names, *, rank: int | None = None,
                 groups: dict | None = None, backend: str | None = None,
                 device=None, global_ranks: tuple | None = None):
        sizes = tuple(int(s) for s in sizes)
        axis_names = tuple(axis_names)
        if len(sizes) != len(axis_names):
            raise ValueError(f"mesh sizes {sizes} and axes {axis_names} "
                             "differ in length")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.size = math.prod(sizes)
        self.rank = rank
        self._groups = groups or {}
        self.backend = backend
        self.device = None if device is None else torch.device(device)
        # the world ranks of the mesh positions, in order
        self.global_ranks = (tuple(range(self.size)) if global_ranks is None
                             else tuple(global_ranks))
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")

    @property
    def is_live(self) -> bool:
        return self.rank is not None

    def __repr__(self) -> str:
        kind = (f"live rank {self.rank}, {self.backend}" if self.is_live
                else "abstract")
        return f"Mesh({self.shape}, {kind})"

    def coords(self, rank: int | None = None) -> dict:
        """Mesh position ``rank`` (this process's by default) as its index
        along each axis, row-major."""
        r = self._live_rank() if rank is None else rank
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _live_rank(self) -> int:
        if self.rank is None:
            raise ValueError("an abstract mesh has no rank: build a live one "
                             "with repro_torch.launch.mesh")
        return self.rank

    def ordered(self, axes) -> tuple:
        """``axes`` (a name or names) as a tuple in the mesh's order; an
        axis the mesh lacks raises."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.shape} has no axis {a!r}")
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {axes} out of the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.ordered(axes))

    def axis_index(self, axes, rank: int | None = None) -> int:
        """This rank's index along ``axes``, row-major over them (the
        reference's ``lax.axis_index``)."""
        c = self.coords(rank)
        i = 0
        for a in self.ordered(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group_ranks(self, axes, rank: int | None = None) -> list:
        """The mesh positions that share this rank's coordinates off
        ``axes``, ordered by their index along ``axes``."""
        axes = self.ordered(axes)
        c = self.coords(rank)
        out = []
        for r in range(self.size):
            cr = self.coords(r)
            if all(cr[a] == c[a] for a in self.axis_names if a not in axes):
                out.append(r)
        return sorted(out, key=lambda r: self.axis_index(axes, r))

    def group(self, axes):
        """The process group of this rank along ``axes``."""
        axes = self.ordered(axes)
        self._live_rank()
        return self._groups[axes]


def abstract_mesh(sizes, axis_names) -> Mesh:
    """A mesh with no processes, for computing specs."""
    return Mesh(sizes, axis_names)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to mesh axes, restricted to a given mesh.

    When a concrete ``shape`` is provided, assignments that don't divide
    the dimension are dropped (rightmost mesh axis first): kv_heads=4 on
    a model=16 mesh falls back to replication."""

    rules: tuple
    mesh_axes: tuple
    axis_sizes: tuple

    @classmethod
    def create(cls, mesh, overrides: dict | None = None) -> "MeshRules":
        rules = dict(DEFAULT_RULES)
        if overrides:
            rules.update(overrides)
        names = tuple(mesh.axis_names)
        clean = {}
        for k, v in rules.items():
            if v is None or v == ():
                clean[k] = None
            else:
                kept = tuple(a for a in v if a in names)
                clean[k] = kept if kept else None
        sizes = tuple((a, int(mesh.shape[a])) for a in names)
        return cls(tuple(sorted(clean.items())), names, sizes)

    def _lookup(self, logical):
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def _size(self, axis: str) -> int:
        for k, v in self.axis_sizes:
            if k == axis:
                return v
        return 1

    def pspec(self, axes: tuple, shape: tuple | None = None) -> P:
        used: set = set()
        parts = []
        for i, a in enumerate(axes):
            m = self._lookup(a)
            if m is None:
                parts.append(None)
                continue
            kept = tuple(x for x in m if x not in used)
            if shape is not None:
                dim = shape[i]
                while kept and dim % math.prod(self._size(x)
                                               for x in kept) != 0:
                    kept = kept[:-1]
            used.update(kept)
            if not kept:
                parts.append(None)
            elif len(kept) == 1:
                parts.append(kept[0])
            else:
                parts.append(kept)
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)


def logical_to_pspec(axes: tuple, mesh, overrides: dict | None = None) -> P:
    return MeshRules.create(mesh, overrides).pspec(axes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the layout of one array."""
    mesh: Mesh
    spec: P

    def shard_shape(self, shape: tuple) -> tuple:
        return shard_shape(shape, self.spec, self.mesh)


def named_sharding(mesh: Mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def flatten_specs(tree_specs) -> list:
    """[(dot.path, spec)] of a spec tree, named and ordered as
    ``common.pytree.flatten_with_paths`` names a tree's leaves (a spec is
    a leaf, not a tuple to walk)."""
    out = []

    def walk(node, prefix):
        if _is_spec(node):
            out.append((".".join(prefix), node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
    walk(tree_specs, ())
    return out


def shard_tree(tree_specs, mesh: Mesh):
    """PartitionSpec tree -> NamedSharding tree (the layout tree)."""
    return _map_specs(lambda s: NamedSharding(mesh, s), tree_specs)


def shard_shape(shape: tuple, spec: P, mesh: Mesh) -> tuple:
    """The shape of one rank's block of an array of ``shape``."""
    out = []
    for i, n in enumerate(shape):
        k = mesh.axis_size(spec.axes(i)) if spec.axes(i) else 1
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {spec.axes(i)} ({k})")
        out.append(n // k)
    return tuple(out)


def shard_slices(shape: tuple, spec: P, mesh: Mesh,
                 rank: int | None = None) -> tuple:
    """The index (a tuple of slices) of mesh position ``rank``'s block
    of an array of ``shape`` (this rank's by default)."""
    local = shard_shape(shape, spec, mesh)
    out = []
    for i, n in enumerate(local):
        axes = spec.axes(i)
        j = mesh.axis_index(axes, rank) if axes else 0
        out.append(slice(j * n, (j + 1) * n))
    return tuple(out)


def local_shard(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole array ``x`` (a view)."""
    return x[shard_slices(tuple(x.shape), spec, mesh)]


def gather_full(x_local: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """The whole array from every rank's block (each rank of the mesh
    calls it): one tiled all-gather a sharded dim."""
    from repro_torch.common import comm
    x = x_local
    for i in range(x.dim()):
        axes = spec.axes(i)
        if axes:
            x = comm.all_gather(x, mesh, axes, dim=i)
    return x


# ---------------------------------------------------------------------------
# 1-D grid meshes for sharded sweep execution (repro_torch.core.sweep)
# ---------------------------------------------------------------------------

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
