"""Pipeline parallelism (GPipe-style) over a "stage" mesh axis (port of
``repro/train/pipeline.py``).

Stages hold disjoint layer slices and microbatches stream through
``ppermute`` (the collective-permute traffic pattern the network
simulator models).  ``gpipe(fn, stage_params, x, mesh)`` runs on every
rank of a live mesh with a ``stage`` axis:

* ``fn(params_slice, x) -> x``: one stage's computation;
* ``stage_params``: this rank's block of leaves shaped (n_stages, ...)
  and sharded over ``stage``, i.e. leaves with a leading dim of 1;
* ``x``: (n_micro, micro_batch, ...), every microbatch (stage 0 reads
  them, the others ignore them).

It returns the last stage's outputs, in microbatch order, on every rank.
The schedule is the reference's: ``n_micro + n_stages - 1`` ticks; stage
0 injects microbatch t at tick t; each tick every stage sends its output
to the next one by one ``ppermute`` around the ring; the last stage
commits microbatch t - n_stages + 1; a masked ``psum`` over ``stage``
gives every rank the outputs.  A stage runs ``fn`` only on the ticks that
carry a microbatch (the reference also runs it on the bubble's
placeholders, whose results no stage commits); the ring still carries a
tensor every tick.
"""
from __future__ import annotations

import torch

from repro_torch.common import comm
from repro_torch.common.pytree import tree_map


def gpipe(fn, stage_params, x: torch.Tensor, mesh,
          stage_axis: str = "stage") -> torch.Tensor:
    n_stages = int(mesh.shape[stage_axis])
    n_micro = x.shape[0]
    params_my = tree_map(lambda p: p[0], stage_params)
    sid = comm.axis_index(mesh, stage_axis)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        if 0 <= t - sid < n_micro:
            cur = x[t] if sid == 0 else buf
            y = fn(params_my, cur)
        else:                       # a bubble: nothing to compute
            y = torch.zeros_like(buf)
        if sid == n_stages - 1 and t - n_stages + 1 >= 0:
            outs[t - n_stages + 1] = y
        buf = comm.ppermute(y, mesh, stage_axis, ring)
    # only the last stage holds the outputs: a masked psum shares them
    if sid != n_stages - 1:
        outs = torch.zeros_like(outs)
    return comm.psum(outs, mesh, stage_axis)
