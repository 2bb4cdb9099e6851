"""The port's collectives (``repro_torch.common.comm``) and rank launcher
(``repro_torch.launch.mesh``) on CPU ranks over ``gloo``: each collective
against its numpy definition on (data=2, model=2) and (data=4) meshes,
under autograd too; the per-rank byte counters; a failing, dying or
mismatched rank failing the launch within seconds instead of hanging;
the join limit; the transport chosen from the device list."""
import time

import numpy as np
import pytest
import torch

from repro_torch.common import comm
from repro_torch.common.sharding import P, abstract_mesh
from repro_torch.launch import mesh as lmesh

JOIN_S = 90
CPU4 = ["cpu"] * 4      # CPU ranks, asked for by name


def _x(rank, shape, seed=0):
    rng = np.random.default_rng(seed + rank)
    return rng.standard_normal(shape).astype(np.float32)


def collectives_rank(rank):
    torch.set_num_threads(1)
    m22 = lmesh.make_mesh((2, 2), ("data", "model"))
    m4 = lmesh.make_mesh((4,), ("data",))
    out = {"coords": m22.coords(), "backend": m22.backend,
           "index": (m22.axis_index("data"), m22.axis_index("model"),
                     m22.axis_index(("data", "model")))}
    x = torch.from_numpy(_x(rank, (4, 6)))
    comm.reset_counters()
    out["psum_data"] = comm.psum(x, m22, "data").numpy()
    out["psum_all"] = comm.psum(x, m22, ("data", "model")).numpy()
    out["gather_model_1"] = comm.all_gather(x, m22, "model", dim=1).numpy()
    out["gather_4"] = comm.all_gather(x, m4, "data").numpy()
    out["scatter_4_1"] = comm.psum_scatter(
        torch.from_numpy(_x(rank, (3, 8))), m4, "data", dim=1).numpy()
    out["a2a_4"] = comm.all_to_all(torch.from_numpy(_x(rank, (8, 2))), m4,
                                   "data").numpy()
    ring = [(i, (i + 1) % 4) for i in range(4)]
    out["ring_4"] = comm.ppermute(x, m4, "data", ring).numpy()
    out["shift_4"] = comm.ppermute(x, m4, "data", [(0, 2), (1, 3)]).numpy()
    out["bf16"] = comm.psum(x.to(torch.bfloat16), m4, "data").float().numpy()
    out["one"] = comm.psum(x, lmesh.make_mesh((4, 1), ("data", "model")),
                           "model").numpy()
    out["counters"] = comm.counters()
    # under autograd: d/dx of sum(w * f(x)) for a fixed w a rank
    grads = {}
    for name, fn, shape in (
            ("a2a", lambda t: comm.all_to_all(t, m4, "data"), (8, 2)),
            ("gather", lambda t: comm.all_gather(t, m4, "data", dim=1),
             (2, 3)),
            ("scatter", lambda t: comm.psum_scatter(t, m4, "data"), (8, 2)),
            ("psum", lambda t: comm.psum(t, m4, "data"), (2, 2)),
            ("ring", lambda t: comm.ppermute(t, m4, "data", ring), (2, 2))):
        t = torch.from_numpy(_x(rank, shape, 7)).requires_grad_()
        y = fn(t)
        w = torch.from_numpy(_x(rank, tuple(y.shape), 9))
        (g,) = torch.autograd.grad((y * w).sum(), t)
        grads[name] = g.numpy()
    out["grads"] = grads
    return out


def test_collectives_match_their_definitions():
    res = lmesh.launch(collectives_rank, 4, devices=CPU4, join_s=JOIN_S)
    xs = [_x(r, (4, 6)) for r in range(4)]
    for r, o in enumerate(res):
        d, m = divmod(r, 2)
        assert o["coords"] == {"data": d, "model": m}
        assert o["index"] == (d, m, r) and o["backend"] == "gloo"
        np.testing.assert_allclose(o["psum_data"], xs[m] + xs[2 + m],
                                   rtol=1e-6)
        np.testing.assert_allclose(o["psum_all"], sum(xs), rtol=1e-6)
        np.testing.assert_array_equal(
            o["gather_model_1"], np.concatenate([xs[2 * d], xs[2 * d + 1]],
                                                axis=1))
        np.testing.assert_array_equal(o["gather_4"], np.concatenate(xs))
        full = sum(_x(q, (3, 8)) for q in range(4))
        np.testing.assert_allclose(o["scatter_4_1"],
                                   full[:, 2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_array_equal(o["a2a_4"], np.concatenate(
            [_x(q, (8, 2))[2 * r:2 * r + 2] for q in range(4)]))
        np.testing.assert_array_equal(o["ring_4"], xs[(r - 1) % 4])
        np.testing.assert_array_equal(
            o["shift_4"], xs[r - 2] if r >= 2 else np.zeros((4, 6)))
        np.testing.assert_array_equal(o["one"], xs[r])
        # gloo adds in bf16: each of the 3 adds rounds (half an ulp of a
        # partial sum, 2^-8 relative), partial sums bounded by sum |x|
        b16 = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in xs]
        np.testing.assert_allclose(o["bf16"], sum(b16), rtol=0,
                                   atol=3 * 2 ** -8 * float(np.abs(
                                       b16).sum(0).max()))
        c = o["counters"]
        assert c["psum"]["calls"] == 3       # the size-1 group sends nothing
        assert c["psum"]["bytes"] == 96 * 2 + 48
        assert c["psum"]["sent"] == 96 + 144 + 72
        assert c["all_gather"] == {"calls": 2, "bytes": 192, "sent": 96 + 288}
        assert c["psum_scatter"] == {"calls": 1, "bytes": 96, "sent": 72}
        assert c["all_to_all"] == {"calls": 1, "bytes": 64, "sent": 48}
        assert c["ppermute"]["calls"] == 1 + (r < 2)
        g = o["grads"]
        # all_to_all: the gradient returns by the same exchange
        w = [_x(q, (8, 2), 9) for q in range(4)]
        np.testing.assert_array_equal(g["a2a"], np.concatenate(
            [w[q][2 * r:2 * r + 2] for q in range(4)]))
        # replicated compute: a gathered value's gradient is this rank's
        # slice of the gradient of the whole, a psum's passes through
        np.testing.assert_array_equal(g["gather"],
                                      _x(r, (2, 12), 9)[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(g["psum"], _x(r, (2, 2), 9))
        np.testing.assert_array_equal(g["scatter"], np.concatenate(
            [_x(q, (2, 2), 9) for q in range(4)]))
        np.testing.assert_array_equal(g["ring"], _x((r + 1) % 4, (2, 2), 9))


def failing_rank(rank, how):
    torch.set_num_threads(1)
    m = lmesh.make_mesh((4,), ("data",))
    if rank == 2:
        if how == "raise":
            raise ValueError("rank 2 gives up")
        if how == "die":
            import os
            os._exit(3)
        if how == "skip":       # the others wait in a psum it never joins
            time.sleep(60)
    comm.psum(torch.ones(3), m, "data")
    return rank


@pytest.mark.parametrize("how,match", [("raise", "rank 2 gives up"),
                                       ("die", "died|failed"),
                                       ("skip", "failed")])
def test_a_failing_rank_fails_the_launch_fast(how, match):
    # the group timeout also bounds the rendezvous: it leaves room for
    # ranks that start late on a loaded host
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        lmesh.launch(failing_rank, 4, devices=CPU4, args=(how,),
                     timeout_s=20,
                     join_s=JOIN_S)
    assert time.monotonic() - t0 < 60


def sleeping_rank(rank):
    time.sleep(120 if rank == 1 else 0)
    return rank


def test_the_join_limit_stops_every_rank():
    t0 = time.monotonic()
    job = lmesh.RankJob(sleeping_rank, 2, devices=["cpu"] * 2)
    with pytest.raises(TimeoutError, match=r"1\] still running after 15"):
        job.join(15)
    assert time.monotonic() - t0 < 45
    assert not any(p.is_alive() for p in job._procs)


def test_backend_follows_the_device_list():
    assert comm.choose_backend(["cpu"] * 4) == "gloo"
    assert comm.choose_backend(["cuda:0"] * 4) == "gloo"
    assert comm.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert comm.choose_backend(["cuda:0", "cuda:0", "cuda:1"]) == "gloo"
    with pytest.raises(ValueError, match="2 devices"):
        lmesh.RankJob(sleeping_rank, 3, devices=["cpu", "cpu"])


def test_ranks_default_to_a_card_each(monkeypatch):
    """Without ``devices`` a rank gets a card of its own; with fewer
    cards than ranks the launcher raises before it starts a process (the
    CPU is asked for by name).  Outside the launcher a rank's device is
    the current card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert lmesh.default_devices(4) == [f"cuda:{i}" for i in range(4)]
    assert lmesh.rank_device() == torch.device("cuda", 2)
    with pytest.raises(RuntimeError, match="5 ranks and 4 visible cards"):
        lmesh.RankJob(sleeping_rank, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="2 ranks and 0 visible cards"):
        lmesh.launch(sleeping_rank, 2)
    assert lmesh.rank_device() == torch.device("cpu")


def test_mesh_coordinates_are_row_major():
    m = abstract_mesh((2, 3), ("data", "model"))
    assert [m.coords(r) for r in (0, 1, 3, 5)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 2}]
    assert m.group_ranks("data", 4) == [1, 4]
    assert m.group_ranks(("data", "model"), 2) == list(range(6))
    assert m.axis_index(("data", "model"), 4) == 4
    with pytest.raises(ValueError, match="order"):
        m.ordered(("model", "data"))
    assert P("a", ("b", "c")).used_axes() == ("a", "b", "c")
