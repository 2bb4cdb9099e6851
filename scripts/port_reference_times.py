"""Completion times of the JAX reference (jnp step, CPU) for the scenarios
that ``chip_smoke.py`` drives through the PyTorch/CUDA port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py

prints one JSON line per (scenario, policy) with ``completion_time``,
``steps_run``, ``finished`` and the total PAUSE count; ``chip_smoke.py``
holds the port's card runs to these values (``REFERENCE`` there).  The
128-GPU runs take a few minutes each on a CPU.
"""
from __future__ import annotations

import json
import sys
import time

from repro.core.engine import EngineConfig
from repro.core.scenario import CollectiveSpec, FabricSpec, ScenarioSpec
from repro.core.sweep import SweepRunner

CFG = EngineConfig(dt=4e-6, max_steps=6000, max_extends=6, queue_stride=0,
                   step_impl="jnp")
SCENARIOS = {
    "clos128_1d": (FabricSpec("clos", n_racks=8, nodes_per_rack=2,
                              gpus_per_node=8, oversubscription=2.0),
                   CollectiveSpec("1d", 128e6), ("pfc", "dcqcn", "hpcc")),
    "clos32_2d": (FabricSpec("clos", n_racks=2, nodes_per_rack=2,
                             gpus_per_node=8, oversubscription=2.0),
                  CollectiveSpec("2d", 128e6), ("dcqcn",)),
}


def main(names):
    runner = SweepRunner(CFG)
    for name in names or SCENARIOS:
        fabric, workload, policies = SCENARIOS[name]
        for pol in policies:
            t0 = time.perf_counter()
            r = runner.run_spec(ScenarioSpec(fabric=fabric, workload=workload,
                                             policy=pol))
            print(json.dumps({
                "scenario": name, "policy": pol,
                "completion_time": r.completion_time,
                "steps_run": r.meta["steps_run"], "finished": r.finished,
                "pause_frames": float(r.pause_count.sum()),
                "n_flows": r.meta["n_flows"],
                "cpu_seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
