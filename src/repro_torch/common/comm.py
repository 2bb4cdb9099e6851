"""Collectives over the axes of a live mesh: the port's counterparts of
``lax.psum``, ``lax.all_gather``, ``lax.psum_scatter``, the tiled
``lax.all_to_all``, ``lax.ppermute`` and ``lax.axis_index``, plus the
process-group set-up behind ``repro_torch.launch.mesh``.  This is the
only module of the port that talks to ``torch.distributed``.

Every rank of the group named by ``axes`` (a mesh axis, or several in the
mesh's order) calls a collective with a tensor of the same shape; a group
of one rank returns its input and sends nothing.  Semantics, with n ranks
along ``axes`` and i this rank's index there:

* ``psum(x)``: the sum over the group, on every rank;
* ``all_gather(x, dim)``: the ranks' blocks concatenated along ``dim`` in
  index order (``tiled=True``);
* ``psum_scatter(x, dim)``: block i of the sum, ``dim`` split in n;
* ``all_to_all(x)``: dim 0 split in n blocks, block j sent to rank j, the
  blocks received concatenated in sender order (``split_axis=0,
  concat_axis=0, tiled=True``);
* ``ppermute(x, perm)``: ``x`` sent along each (source, destination) pair
  of index pairs; a rank nothing is sent to gets zeros;
* ``pmax(x)``: the elementwise maximum over the group (no gradient).

**Tensor-parallel entries** (Megatron-LM's conjugate operators):
``tp_enter(x)`` is the identity forward and a ``psum`` backward (the "f"
before a column-parallel product, whose input's gradient is partial on
each rank); ``tp_enter(x, dim=d)`` all-gathers dim ``d`` forward and
reduce-scatters it backward (sequence parallelism's entry);
``tp_split(x, dim=d)`` keeps this rank's block of dim ``d`` forward and
all-gathers it backward.

**Recording.**  Under a ``RecordingMesh`` (rank i of an abstract mesh,
no process group) every collective appends a ``Record`` (its kind as
the compiled HLO names it, the bytes of this rank's input buffer and of
its result, the group's size and the number of groups) and returns a
tensor of the result's shape on the ``meta`` device: the dry run's
record of one rank's traffic (``repro_torch.launch.dryrun``).

**Transport.**  ``choose_backend(devices)`` follows the mesh's device
list: NCCL when every rank owns a card of its own, ``gloo`` when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
On the card's machine (torch 2.11+cu128) ``gloo`` took CUDA tensors,
float32 and bf16, in ``all_reduce``, ``broadcast``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` (staging them through the host itself), and
refused them in ``batch_isend_irecv`` (``gloo::IoException: writev ...
Bad address``, an abort no caller can catch: ``GLOO_CUDA``).  So under
``gloo`` a CUDA tensor goes to the first four as it is, and ``ppermute``
copies it to the host, exchanges it there and copies it back to its
device (``_to_wire`` / ``_from_wire``); the compute stays on the card.

**Byte counters.**  Each call adds, under its kind, one call, the bytes
of its input buffer (``bytes``: what a collective "of N bytes" means, as
``DLRMCommSpec`` counts) and the bytes this rank sends on a ring
(``sent``: 2 (n - 1) / n of the buffer for ``psum`` and ``pmax``,
(n - 1) / n for ``psum_scatter`` and ``all_to_all``, (n - 1) x the block
for ``all_gather``, the buffer for each ``ppermute`` hop to another
rank).
``reset_counters`` and ``counters`` read them per rank.  Inside
``section(name)`` a call is also counted under ``name``
(``counters(name)``) and its ``Record`` carries ``name``: the dry run
keeps a prefill's hand-off into a sequence-split cache apart that way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime

import torch
import torch.distributed as dist

from repro_torch.common.sharding import Mesh

KINDS = ("psum", "all_gather", "psum_scatter", "all_to_all", "ppermute",
         "pmax")
# the compiled HLO's name of each kind
HLO_KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
             "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
             "all_to_all": "all-to-all", "ppermute": "collective-permute"}
_COUNTS: dict = {}
_SECTIONS: dict = {}        # section name -> its counters
_SECTION = [None]           # the open section's name


def _zeros() -> dict:
    return {k: {"calls": 0, "bytes": 0, "sent": 0} for k in KINDS}


def reset_counters() -> None:
    _COUNTS.clear()
    _COUNTS.update(_zeros())
    _SECTIONS.clear()


reset_counters()


def counters(section: str | None = None) -> dict:
    """{kind: {"calls", "bytes", "sent"}} since the last reset: of every
    call, or of those made inside ``section(section)``."""
    src = _COUNTS if section is None else _SECTIONS.get(section, _zeros())
    return {k: dict(v) for k, v in src.items()}


@contextlib.contextmanager
def section(name: str):
    """Count (and record) the collectives made inside under ``name`` as
    well as under their kind."""
    prev, _SECTION[0] = _SECTION[0], name
    try:
        yield
    finally:
        _SECTION[0] = prev


def _count(kind: str, x: torch.Tensor, sent: float, mesh=None, axes=(),
           out_numel: int | None = None) -> bool:
    """Counts one call; under a ``RecordingMesh`` also records it and
    returns True (the caller then returns a ``meta`` result)."""
    nbytes = x.numel() * x.element_size()
    name = _SECTION[0]
    for c in ([_COUNTS] if name is None else
              [_COUNTS, _SECTIONS.setdefault(name, _zeros())]):
        c[kind]["calls"] += 1
        c[kind]["bytes"] += nbytes
        c[kind]["sent"] += int(round(sent))
    if not isinstance(mesh, RecordingMesh):
        return False
    n = mesh.axis_size(axes)
    out = x.numel() if out_numel is None else out_numel
    mesh.records.append(Record(kind, tuple(axes), nbytes,
                               out * x.element_size(), n, mesh.size // n,
                               name))
    return True


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective as a recording mesh saw it on its rank."""
    kind: str               # the port's kind (``KINDS``)
    axes: tuple             # the mesh axes of its group
    bytes: int              # this rank's input buffer
    out_bytes: int          # this rank's result
    group_size: int
    n_groups: int
    section: str | None = None      # ``section``'s name, if one was open

    @property
    def hlo_kind(self) -> str:
        return HLO_KINDS[self.kind]


class RecordingMesh(Mesh):
    """Rank ``rank`` of the mesh ``sizes`` x ``axis_names`` with no
    process: it reports itself live, and every collective over it is
    appended to ``records`` and returns a ``meta`` tensor."""

    def __init__(self, sizes, axis_names, rank: int = 0):
        super().__init__(sizes, axis_names, rank=rank, backend="record",
                         device="meta")
        self.records: list = []

    def __repr__(self) -> str:
        return f"RecordingMesh({self.shape}, rank {self.rank})"


def _meta(shape, x: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=x.dtype, device="meta")


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def choose_backend(devices) -> str:
    """``"nccl"`` when every device is a distinct card, else ``"gloo"``
    (ranks sharing a card, or CPU ranks)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def init(backend: str, init_method: str, rank: int, world_size: int,
         timeout_s: float) -> None:
    """This process's place in the world group; every collective of the
    run gives up after ``timeout_s`` seconds."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple:
    """(rank, world size, backend) of this process's world group."""
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def build_groups(mesh_sizes: dict, global_ranks: tuple, backend: str,
                 timeout_s: float) -> dict:
    """One process group per non-empty set of mesh axes (keyed by the axes
    in the mesh's order) holding this rank: every process of the world
    calls it, for every group, in the same order (``new_group``'s rule),
    members of the mesh or not."""
    from itertools import combinations

    names = tuple(mesh_sizes)
    probe = Mesh(tuple(mesh_sizes.values()), names)
    me = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in combinations(names, k):
            seen = set()
            for pos in range(probe.size):
                members = tuple(probe.group_ranks(axes, pos))
                if members in seen:
                    continue
                seen.add(members)
                ranks = [global_ranks[m] for m in members]
                g = dist.new_group(ranks, timeout=timeout, backend=backend)
                if me in ranks:
                    groups[axes] = g
    return groups


def barrier(group=None) -> None:
    dist.barrier(group=group)


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order (small metadata)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

# the torch.distributed calls gloo takes CUDA tensors in
GLOO_CUDA = frozenset({"all_reduce", "all_gather_into_tensor",
                       "reduce_scatter_tensor", "all_to_all_single"})


def _staged(x: torch.Tensor, mesh, op: str = "batch_isend_irecv") -> bool:
    return mesh.backend == "gloo" and x.is_cuda and op not in GLOO_CUDA


def _to_wire(x: torch.Tensor, mesh, op: str,
             written: bool = False) -> torch.Tensor:
    """``x`` as a contiguous buffer for ``op``: a host copy where ``gloo``
    refuses the CUDA tensor in ``op``, a copy on ``x``'s device where the
    transport writes it (``written``), else ``x`` itself."""
    if _staged(x, mesh, op):
        return x.detach().to("cpu", copy=True).contiguous()
    if written:
        return x.detach().clone(memory_format=torch.contiguous_format)
    return x.detach().contiguous()


def _from_wire(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return buf.to(x.device) if buf.device != x.device else buf


def _empty_wire(shape, x: torch.Tensor, mesh, op: str) -> torch.Tensor:
    dev = "cpu" if _staged(x, mesh, op) else x.device
    return torch.empty(shape, dtype=x.dtype, device=dev)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (``lax.axis_index``)."""
    return mesh.axis_index(axes)


def _psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = mesh.ordered(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if _count("psum", x, 2 * (n - 1) / n * x.numel() * x.element_size(),
              mesh, axes):
        return _meta(x.shape, x)
    buf = _to_wire(x, mesh, "all_reduce", written=True)
    dist.all_reduce(buf, group=mesh.group(axes))
    return _from_wire(buf, x)


def _pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = mesh.ordered(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if _count("pmax", x, 2 * (n - 1) / n * x.numel() * x.element_size(),
              mesh, axes):
        return _meta(x.shape, x)
    buf = _to_wire(x, mesh, "all_reduce", written=True)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return _from_wire(buf, x)


def _all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    axes = mesh.ordered(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= n
    if _count("all_gather", x, (n - 1) * x.numel() * x.element_size(), mesh,
              axes, n * x.numel()):
        return _meta(shape, x)
    op = "all_gather_into_tensor"
    src = _to_wire(x.movedim(dim, 0), mesh, op)
    out = _empty_wire((n * src.shape[0],) + tuple(src.shape[1:]), x, mesh,
                      op)
    dist.all_gather_into_tensor(out, src, group=mesh.group(axes))
    return _from_wire(out, x).movedim(0, dim)


def _psum_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    axes = mesh.ordered(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {axes} ({n})")
    shape = list(x.shape)
    shape[dim] //= n
    if _count("psum_scatter", x, (n - 1) / n * x.numel() * x.element_size(),
              mesh, axes, x.numel() // n):
        return _meta(shape, x)
    op = "reduce_scatter_tensor"
    src = _to_wire(x.movedim(dim, 0), mesh, op)
    out = _empty_wire((src.shape[0] // n,) + tuple(src.shape[1:]), x, mesh,
                      op)
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    return _from_wire(out, x).movedim(0, dim)


def _all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = mesh.ordered(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {axes} ({n})")
    if _count("all_to_all", x, (n - 1) / n * x.numel() * x.element_size(),
              mesh, axes):
        return _meta(x.shape, x)
    src = _to_wire(x, mesh, "all_to_all_single")
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return _from_wire(out, x)


def _ppermute(x: torch.Tensor, mesh, axes, perm) -> torch.Tensor:
    axes = mesh.ordered(axes)
    members = mesh.group_ranks(axes)
    i = mesh.axis_index(axes)
    dst = [d for s, d in perm if s == i]
    src = [s for s, d in perm if d == i]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if isinstance(mesh, RecordingMesh):
        if dst and dst[0] != i:
            _count("ppermute", x, x.numel() * x.element_size(), mesh, axes)
        return _meta(x.shape, x)
    out = torch.zeros_like(x)
    ops = []
    buf = _to_wire(x, mesh, "batch_isend_irecv")
    recv = _empty_wire(tuple(x.shape), x, mesh, "batch_isend_irecv")
    group = mesh.group(axes)
    if dst and dst[0] != i:
        _count("ppermute", x, x.numel() * x.element_size())
        ops.append(dist.P2POp(dist.isend, buf,
                              mesh.global_ranks[members[dst[0]]], group))
    if src and src[0] != i:
        ops.append(dist.P2POp(dist.irecv, recv,
                              mesh.global_ranks[members[src[0]]], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if src:
        out = x.clone() if src[0] == i else _from_wire(recv, x)
    return out


# ---------------------------------------------------------------------------
# the public collectives, under autograd too
# ---------------------------------------------------------------------------
# A tensor that requires grad goes through an autograd Function.  The
# backward follows the SPMD convention of a replicated computation: after a
# psum or an all-gather every rank of the group computes the same function
# of the same value, and the loss counts it once, so each rank's gradient
# of the reduced or gathered value is already the true one: a psum's
# backward is the identity and an all-gather's its rank's slice.  An
# all-to-all returns by the same exchange, a psum_scatter by an all-gather
# of the blocks' gradients, a ppermute by the inverse permutation.

def _ad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _psum_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_to_all(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, perm):
        ctx.mesh, ctx.axes, ctx.perm = mesh, axes, perm
        return _ppermute(x, mesh, axes, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _ppermute(g.contiguous(), ctx.mesh, ctx.axes, inv), None, \
            None, None


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axes), None, None


class _TpEnterGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_psum_scatter(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


class _TpSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


def _block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axes} ({n})")
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * k, k)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _Psum.apply(x, mesh, axes) if _ad(x) else _psum(x, mesh, axes)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum over the group, detached (its callers,
    log-sum-exp's shift, need no gradient through it)."""
    return _pmax(x.detach(), mesh, axes)


def tp_enter(x: torch.Tensor, mesh, axes, dim: int | None = None):
    """The entry of a tensor-parallel block: ``x`` as it is (``dim``
    None) or all-gathered along ``dim``, whose gradient is summed (or
    reduce-scattered along ``dim``) over ``axes`` in the backward."""
    if dim is None:
        return _TpEnter.apply(x, mesh, axes) if _ad(x) else x
    if _ad(x):
        return _TpEnterGather.apply(x, mesh, axes, dim)
    return _all_gather(x, mesh, axes, dim)


def tp_split(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (no traffic), whose
    gradient is all-gathered over ``axes`` in the backward."""
    return _TpSplit.apply(x, mesh, axes, dim) if _ad(x) else \
        _block(x, mesh, axes, dim)


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    if _ad(x):
        return _AllGather.apply(x, mesh, axes, dim)
    return _all_gather(x, mesh, axes, dim)


def psum_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    if _ad(x):
        return _PsumScatter.apply(x, mesh, axes, dim)
    return _psum_scatter(x, mesh, axes, dim)


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if _ad(x):
        return _AllToAll.apply(x, mesh, axes)
    return _all_to_all(x, mesh, axes)


def ppermute(x: torch.Tensor, mesh, axes, perm) -> torch.Tensor:
    """``perm``: (source index, destination index) pairs along ``axes``."""
    perm = [tuple(p) for p in perm]
    if _ad(x):
        return _Ppermute.apply(x, mesh, axes, perm)
    return _ppermute(x, mesh, axes, perm)
