"""Fabric and schedule builders of the port (numpy copies) produce the
reference's arrays exactly, for every registered collective."""
import numpy as np
import pytest

from repro.core import collectives as rcoll
from repro.core import topology as rtopo
from repro_torch.core import collectives as pcoll
from repro_torch.core import topology as ptopo

FABRICS = {
    "single8": lambda m: m.single_switch(8),
    "clos_1x2x4": lambda m: m.clos(n_racks=1, nodes_per_rack=2,
                                   gpus_per_node=4),
    "clos32_paper": lambda m: m.clos(n_racks=2, nodes_per_rack=2,
                                     gpus_per_node=8, n_spines=8),
    "clos128_paper": lambda m: m.clos(n_racks=8, nodes_per_rack=2,
                                      gpus_per_node=8, n_spines=8),
}
TOPO_ARRAYS = ("cap", "lat", "src_dev", "dst_dev", "ecn_on", "fabric",
               "link_class", "dev_is_switch", "dev_buf", "up_link")
SCHED_ARRAYS = ("path", "n_hops", "size", "group", "dep", "delay")


def _unique_collectives():
    seen, names = set(), []
    for name, fn in rcoll.COLLECTIVES.items():
        if fn not in seen:
            seen.add(fn)
            names.append(name)
    return names


def test_registries_and_constants_match():
    assert sorted(pcoll.COLLECTIVES) == sorted(rcoll.COLLECTIVES)
    assert ptopo.LINK_CLASSES == rtopo.LINK_CLASSES
    assert ptopo.MAXHOP == rtopo.MAXHOP


@pytest.mark.parametrize("fabric", list(FABRICS))
def test_topology_arrays_identical(fabric):
    r, p = FABRICS[fabric](rtopo), FABRICS[fabric](ptopo)
    assert (r.name, r.n_devices, r.n_gpus, r.dev_name) == \
        (p.name, p.n_devices, p.n_gpus, p.dev_name)
    for k in TOPO_ARRAYS:
        a, b = getattr(r, k), getattr(p, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


# hierarchical collectives need a multi-node fabric
SCHED_CASES = [(f, k) for f in FABRICS for k in _unique_collectives()
               if not (f == "single8"
                       and k in ("allreduce_2d", "allreduce_hring"))]


@pytest.mark.parametrize("fabric,kind", SCHED_CASES,
                         ids=[f"{f}-{k}" for f, k in SCHED_CASES])
def test_schedule_arrays_identical(fabric, kind):
    rt, pt = FABRICS[fabric](rtopo), FABRICS[fabric](ptopo)
    gpus = list(range(rt.n_gpus))
    r = rcoll.get_collective(kind)(rt, gpus, 64e6)
    p = pcoll.get_collective(kind)(pt, gpus, 64e6)
    assert (r.n_groups, r.group_names) == (p.n_groups, p.group_names)
    for k in SCHED_ARRAYS:
        a, b = getattr(r, k), getattr(p, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_incast_and_dependency_checks_match():
    rt, pt = rtopo.single_switch(8), ptopo.single_switch(8)
    r = rcoll.incast(rt, [1, 2, 3, 5], 0, 3e6)
    p = pcoll.incast(pt, [1, 2, 3, 5], 0, 3e6)
    for k in SCHED_ARRAYS:
        assert np.array_equal(getattr(r, k), getattr(p, k)), k
    b = pcoll.ScheduleBuilder(pt)
    g = b.new_group("x")
    b.add_flow(1, 0, 1e6, g, dep=g)
    with pytest.raises(ValueError, match="its own group"):
        b.build()
