"""Meshes and the processes behind them (port of ``repro/launch/mesh.py``,
plus the rank launcher the port's multi-controller design needs).

``make_production_mesh(multi_pod=)`` and ``make_mesh(shape, axes)`` give
the reference's meshes: *abstract* (specs only) when no process group is
initialised, *live* when this process is a rank of a world whose size is
the mesh's.  A live mesh maps ranks to coordinates row-major, as
``jax.make_mesh`` lays out host devices, and holds one process group per
set of axes (``repro_torch.common.comm.build_groups``).

``launch(fn, n, devices=...)`` runs ``fn(rank, *args)`` in ``n`` processes
(``torch.multiprocessing``, spawned), one per mesh position, on
``devices[rank]``: by default one rank a visible card (``cuda:<rank>``);
ranks that share a card, or run on the CPU, are asked for by name.  They rendezvous through a ``file://`` path under a
temporary directory, so parallel test workers never share a port; every
process group has a timeout; the parent joins with a limit, and the first
rank that raises or dies stops every other rank and fails the launch with
its traceback: a rank never stays waiting in a collective.  ``RankJob``
is the same without the join, for a caller that does other work first.
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from repro_torch.common import comm
from repro_torch.common.sharding import Mesh, abstract_mesh

GROUP_TIMEOUT_S = 300.0
_DEVICE: dict = {}       # this rank's device, set by the launcher


def rank_device() -> torch.device:
    """The device the launcher gave this rank; outside the launcher, the
    current card (the CPU on a host without one)."""
    if "device" in _DEVICE:
        return _DEVICE["device"]
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def default_devices(n: int) -> list:
    """One card a rank, ``cuda:0`` .. ``cuda:<n-1>``; raises without as
    many cards (the CPU, or ranks sharing a card, are asked for by
    name)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"{n} ranks and {have} visible cards: pass "
                           "devices= (e.g. ['cpu'] * n, or one card named "
                           "n times)")
    return [f"cuda:{i}" for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple, axes: tuple,
              ranks: tuple | None = None) -> Mesh | None:
    """The mesh of ``shape`` over ``axes``.  Abstract when no process group
    is initialised; live on a rank of a world group otherwise, over the
    world ranks ``ranks`` (every rank, in order, by default; every process
    of the world calls it, and a process outside ``ranks`` gets None).  A
    world whose size is not the mesh's raises."""
    size = 1
    for s in shape:
        size *= int(s)
    if not comm.is_initialized():
        return abstract_mesh(shape, axes)
    rank, world, backend = comm.world()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if len(ranks) != size or list(ranks) != sorted(set(ranks)):
        raise ValueError(f"a mesh of {dict(zip(axes, shape))} wants {size} "
                         f"increasing world ranks, got {ranks} of {world}")
    groups = comm.build_groups(dict(zip(axes, shape)), ranks, backend,
                               _DEVICE.get("timeout_s", GROUP_TIMEOUT_S))
    if rank not in ranks:
        return None
    return Mesh(shape, axes, rank=ranks.index(rank), groups=groups,
                backend=backend, device=rank_device(), global_ranks=ranks)


# ---------------------------------------------------------------------------
# launching one process per mesh position
# ---------------------------------------------------------------------------

def _rank_main(rank, n, fn, args, init_method, backend, devices, timeout_s,
               results):
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _DEVICE.update(device=dev, timeout_s=timeout_s)
        comm.init(backend, init_method, rank, n, timeout_s)
        out = fn(rank, *args)
        results.put(("ok", rank, out))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        comm.destroy()


class RankJob:
    """``n`` ranks of ``fn(rank, *args)`` started now; ``join`` waits."""

    def __init__(self, fn, n: int, *, devices=None, args: tuple = (),
                 timeout_s: float = GROUP_TIMEOUT_S,
                 tmpdir: str | None = None):
        devices = list(devices) if devices is not None else \
            default_devices(n)
        if len(devices) != n:
            raise ValueError(f"{n} ranks, {len(devices)} devices")
        self.n = n
        self.backend = comm.choose_backend(devices)
        self._own_tmp = tmpdir is None
        self.tmpdir = tmpdir or tempfile.mkdtemp(prefix="repro_torch_mesh_")
        os.makedirs(self.tmpdir, exist_ok=True)
        rdv = os.path.join(self.tmpdir, "rendezvous")
        if os.path.exists(rdv):
            os.remove(rdv)
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, n, fn, args, "file://" + rdv, self.backend, devices,
                  timeout_s, self._results), daemon=False)
            for r in range(n)]
        for p in self._procs:
            p.start()
        self._out: dict = {}

    def _drain(self, wait_s: float) -> None:
        try:
            status, rank, out = self._results.get(timeout=wait_s)
        except queue_mod.Empty:
            return
        if status == "error":
            self.terminate()
            raise RuntimeError(f"rank {rank} of {self.n} failed:\n{out}")
        self._out[rank] = out

    def join(self, limit_s: float | None = None) -> list:
        """Every rank's return value, by rank.  A rank that raises, dies or
        outlives ``limit_s`` seconds stops them all and raises."""
        deadline = None if limit_s is None else time.monotonic() + limit_s
        try:
            while len(self._out) < self.n:
                self._drain(0.2)
                for r, p in enumerate(self._procs):
                    if r in self._out or p.is_alive():
                        continue
                    # its result or error may still be in the queue's pipe
                    self._drain(30.0 if p.exitcode == 0 else 2.0)
                    if r not in self._out:
                        self.terminate()
                        raise RuntimeError(f"rank {r} of {self.n} died "
                                           f"(exit {p.exitcode})")
                if deadline is not None and time.monotonic() > deadline:
                    self.terminate()
                    raise TimeoutError(f"ranks {sorted(set(range(self.n)) - set(self._out))} "
                                       f"still running after {limit_s} s")
            for p in self._procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            return [self._out[r] for r in range(self.n)]
        finally:
            if any(p.is_alive() for p in self._procs):
                self.terminate()
            self._cleanup()

    def terminate(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()

    def _cleanup(self) -> None:
        if self._own_tmp:
            shutil.rmtree(self.tmpdir, ignore_errors=True)


def launch(fn, n: int, *, devices=None, args: tuple = (),
           timeout_s: float = GROUP_TIMEOUT_S, join_s: float | None = None,
           tmpdir: str | None = None) -> list:
    """Run ``fn(rank, *args)`` on ``n`` ranks (``devices[rank]``, one card
    a rank by default) and return their results by rank (see
    ``RankJob``)."""
    return RankJob(fn, n, devices=devices, args=args, timeout_s=timeout_s,
                   tmpdir=tmpdir).join(join_s)
