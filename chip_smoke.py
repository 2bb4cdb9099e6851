#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the engine-step, DCQCN-update, embedding-bag (forward and
backward) and flash-decode kernels, holds each against its plain PyTorch
version (the engine kernels also inside one step of Fig 12's nine lanes
and of Fig 13's eight lossy lanes, against the op path), drives the
simulator's main path through the kernels at the paper's 128-GPU scale
and at 32 GPUs,
drives the DCQCN update through its entry point, runs Fig 12's fabric
sweep as one batch of 9 lanes, again over a mesh of the card twice
(``mesh_lanes``: bit-equal), and the 128-GPU policy comparison as one
policy-axis batch, runs Fig 13's loss, recovery and flap lanes as one
batch on the lossy fabric, the 32-GPU all-reduce under loss, a weakened
ECN and a degradation window, the learned ``mlp`` policy at 128 GPUs
lossless and lossy and all eight policies on the held-out incast of
``examples/learn_cc.py``, scores a batch on the
paper's Table II DLRM through the embedding-bag kernel, simulates that
DLRM's training iteration on the 128-GPU platform under PFC and DCQCN,
serves TinyLlama-1.1B (full width and depth) through ``python -m
repro_torch.launch.serve``'s entry point and on a 32,768-token cache with
decode attention in the flash-decode kernel, serves Gemma-2 9B (full
width and depth, a prompt past its 4,096 window), Gemma-3 27B (12
layers) and Phi-4-mini through ``ServeEngine`` with the kernel on global
and ring layers, its logit softcap included (``serve_gemma2``,
``serve_gemma3``, ``serve_phi4``), holds Gemma-2 and Gemma-3 at one
period against the JAX reference's logits (``serve_sliding_reference``),
times the softcap's instantiation at Gemma-2's decode shape, and checks
the results
against the plain paths, the port's serial runs and constants from the
JAX reference.  Training (since the slice that ported it): the bags'
backward kernel against its plain version at Table II's shape and at a
table of 100 rows (``bags_backward_check``, bit for bit), three AdamW
steps of the Table II DLRM through both bag kernels, repeated and against
the plain bags bit for bit (``train_dlrm``), TinyLlama-1.1B at full width
and depth with flash attention at 8 x 2,048 tokens and microbatches of 4
(``train_tinyllama``), the smoke TinyLlama and DLRM against the JAX
reference's losses and gradient norms (``train_reference``), and
``python -m repro_torch.launch.train`` with a failure injected, resumed
to the uninterrupted run's log bit for bit (``train_entry``).  The
device mesh (phase 7d, one job of four ranks sharing the card over
``gloo``, started beside ``train_dlrm`` and let go once it has freed the
card): the Table II DLRM's hybrid-parallel step on (data=4), tables over
data, ZeRO-1, the bag kernels on each rank's table block, against one
process (``mesh_dlrm``, with its bytes by collective beside
``DLRMCommSpec``'s); a checkpoint saved with its specs restored into one
process bit for bit and onto (data=2) for a fourth step
(``mesh_elastic``); DeepSeek-V2 at 2 layers under ``ep_a2a`` and ``tp``
against the dense path (``mesh_moe``); and 8 TinyLlama layers through
``gpipe`` over 4 stages, bit-equal to the sequential stack
(``mesh_gpipe``).  Three
gradient phases run through autograd on the simulator's op path, each in
a process of its own beside the main process's kernel checks and
simulator phases (Fig 12's lanes, the policy axis, Fig 13's fault grid
and the learned policy at 128 GPUs run in such processes too; every
kernel is timed after they are done): ``examples/cc_autotune.py``'s CC
and fabric tunings (``autotune_incast8``), one Adam step of the ``mlp``
trainer's curriculum (``learn_step``), and the soft cost's gradient at 32
GPUs against the reference and at the paper's 128 GPUs with remat
(``soft_grad``).  Beside them it measures the backend calibration on the
card (``calibrate``: serial against batched runs, persisted to a temporary
``REPRO_CACHE_DIR``); two more children run resilient campaigns: the committed 128-GPU atlas
(``experiments/atlas/atlas_paper_ring128.csv``) through ``run_campaign``
until the child SIGKILLs itself before its third chunk, which the main
process then resumes from the journal and holds cell by cell against the
CSV (``campaign_atlas128``), and, after a warm start of the persisted
table, the retry ladder under injected out-of-memory errors on 32 GPUs, on one
device and over a mesh of the card twice (``campaign_ladder32``, its
``no_mesh`` rung), and the HLO-replay prediction of every policy,
batched and serial (``predict32``).  ``soft_grad`` runs the 32-GPU
gradient twice and the 128-GPU backward twice over a 64-step window: each
must repeat bit for bit, its backward's sums in a fixed order through
``segment_reduce``.  It also checks
the int8 instantiation of the flash-decode kernel and serves TinyLlama
with the int8 KV cache (``serve_int8``), Zamba2 (``serve_zamba2``),
RWKV-6 (``serve_rwkv6``) and DeepSeek-V2/V3 (``serve_deepseek``), each
new family held against the JAX reference's logits
(``serve_families_reference``).

    python3 chip_smoke.py

Every phase prints one JSON line; a failed phase raises, so the script
exits non-zero.  The line before the last is the kernel table
(``{"kernels": [...]}``), the last line ``{"ok": true, "device": ...}``.
Each kernel row has the event time of back-to-back direct launches
(``ms``; flash_decode's cycles over input sets larger than the L2, its
L2-resident time is ``ms_hot``), the host's µs per launch, and the mean
device µs per call from a ``torch.profiler`` trace taken at the end of
the run (``device_us``), for the kernel and its library call; the fused
kernel's row is timed cold (inputs cycled past the L2) under DCQCN at the
128-GPU shape, with its ``mlp`` body's times (``mlp_*``) and both
policies' times at Fig 12's nine lanes (``b9_*``, ``mlp_b9_*``) beside.
The segment kernels' rows are timed on the PAUSE tally of the 128-GPU
step and the per-port plan of the 32-GPU step, with the 128-GPU step's
split-row qlink and qport plans beside (``qlink_*``, ``qport128_*``) and
``index_add_`` over the same values (``index_add_*``); they are held bit
for bit against their plain versions on every plan of the simulated
scenarios, and the main paths must launch them once per non-empty plan
and step.
The policies' scalar device functions are held against their plain
versions over every float32 input (``scalar_exhaustive``).
Without CUDA, or outside a checkout holding ``src/repro_torch``, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/engine_step/csrc/engine_step.cu"
CCU_SOURCE = "src/repro_torch/kernels/cc_update/csrc/cc_update.cu"
EMB_SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
EMB_BWD_SOURCE = ("src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag_backward.cu")
FD_SOURCE = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
SOURCES = {"fused_signals_policy": KERNEL_SOURCE,
           "segment_reduce": KERNEL_SOURCE,
           "segment_reduce_pfc": KERNEL_SOURCE,
           "dcqcn_update": CCU_SOURCE,
           "embedding_bag_rows": EMB_SOURCE,
           "embedding_bag_backward": EMB_BWD_SOURCE,
           "flash_decode": FD_SOURCE}
REPLACES = {
    "fused_signals_policy": "src/repro/kernels/engine_step/engine_step.py:96",
    "segment_reduce": "src/repro/kernels/engine_step/engine_step.py:171",
    "segment_reduce_pfc": "src/repro/kernels/engine_step/engine_step.py:195",
    "dcqcn_update": "src/repro/kernels/cc_update/cc_update.py:61",
    "embedding_bag_rows":
        "src/repro/kernels/embedding_bag/embedding_bag.py:31",
    # no Pallas kernel: the reference's jnp bags, whose gradient jax.grad
    # takes as a scatter-add
    "embedding_bag_backward": "src/repro/models/dlrm.py:86",
    "flash_decode": "src/repro/kernels/flash_decode/flash_decode.py:60",
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores

# The JAX reference (jnp step, CPU) on the same scenarios, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py
# (jax 0.9.0, numpy 2.0.2).  Completion times must agree within two steps.
REFERENCE = {
    ("clos128_1d", "pfc"): 0.020479999482631683,
    ("clos128_1d", "dcqcn"): 0.023399999365210533,
    ("clos128_1d", "hpcc"): 0.024675998836755753,
    ("clos32_2d", "dcqcn"): 0.002959999954327941,
}

# The DLRM training iteration on the 128-GPU platform, 2D all-reduce, by
# the JAX reference with the All-To-All salted by zlib.crc32 (the port's
# salt), from the same script (jax 0.9.0, numpy 2.0.2): 152,581 flows.
# Times must agree within two steps, PAUSE frames within rtol 1e-3 + 1.
DLRM_ITER_REFERENCE = {
    "pfc": {"iteration_time": 0.006173999939113856,
            "exposed_comm": 0.0025939999391138557, "pfc_pauses": 27308},
    "dcqcn": {"iteration_time": 0.0070779998376965525,
              "exposed_comm": 0.0034979998376965526, "pfc_pauses": 10600},
}
DLRM_ITER_FLOWS = 152581

# batch_fig12's lanes 0 and 8, each as a serial run of the JAX reference
# (jnp step, CPU), from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py batch_fig12
# (jax 0.9.0, numpy 2.0.2): 65,024 flows.  Completion within two steps,
# PAUSE frames within rtol 1e-3 + 1.
FIG12_REFERENCE = {
    0: {"completion_time": 0.012055999599397182,
        "pause_frames": 256878.015625},
    8: {"completion_time": 0.013543999753892422,
        "pause_frames": 101965.2734375},
}
FIG12_FLOWS = 65024

# cc_update_check: the DCQCN update kernel against its plain version
CCU_FLOWS = (7, 128, 300, 1000, 1500, 7936, 130048)
CCU_TIMES = (3.3e-4, 2e-3)
# cc_update_path: the entry point driven over a DCQCN trajectory of the
# 128-GPU all-reduce's flow count
CCU_PATH_FLOWS, CCU_PATH_STEPS = 130048, 400

DT = 4e-6

# batch_fig12: Fig 12's fabric sweep at paper scale
# (benchmarks/figures.py:190-210): the 128-GPU 8-rack CLOS at
# oversubscription 4, an All-To-All of 64 MB, DCQCN, 9 lanes of paired
# (kmin, 4*kmin) ECN ramps crossed with xoff, in one run_batch
FIG12_RACKS, FIG12_OVERSUB = 8, 4.0
FIG12_BYTES = 64e6
FIG12_POLICY = "dcqcn"
FIG12_CHECK_LANES = (0, 8)
# batched_step_check: the kernel-path step held against the op path
FIG12_STEP_AT = 600
# lane counts the engine kernels are held against their plain versions at:
# one, a few, and Fig 12's nine
CHECK_LANES = (1, 3, 9)
# flow counts the fused kernel is held at besides the main paths' padded
# counts: one flow, the edges of its 128-flow tile, and the unpadded and
# padded 128-GPU counts' neighbours (odd counts take the 4-byte cp.async
# route)
FUSED_EDGE_FLOWS = (1, 255, 256, 257, 1500, 7936, 130049, 131072)
# time_flash_decode: input sets cycled for the cold time, and the live K/V
# bytes they must exceed together (the H100's L2 is 50 MB)
FD_COLD_SETS, FD_COLD_BYTES = 4, 64e6
# decode_kernel_check: (Hkv, G, D) of Gemma-2, Gemma-3 and Phi-4-mini's
# decode, each with its attention-logit softcap (Gemma-2's 50; the
# others have none, and are checked at 50 too) and without
FD_ARCH_SHAPES = {(8, 2, 256): 50.0, (16, 2, 128): 50.0, (8, 3, 128): 50.0}
# time_flash_decode_softcap: Gemma-2's decode on a full ring (window
# 4,096), 2 rows, softcap 50
FD_SOFTCAP_SHAPE = (2, 8, 2, 256, 4096, 50.0)       # B, Hkv, G, D, L, cap


def fig12_points() -> np.ndarray:
    """The sweep's (kmin, kmax, xoff) rows, as the figure builds them."""
    return np.array([(k, 4.0 * k, x) for k in (100e3, 400e3, 1000e3)
                     for x in (0.25e6, 1e6, 4e6)], np.float32)


def fig12_scenario() -> tuple:
    """Fig 12's ``(topo, sched, policy)``: 65,024 flows over 576 links."""
    from repro_torch.core import CollectiveSpec, FabricSpec, ScenarioSpec
    fab = FabricSpec("clos", n_racks=FIG12_RACKS, nodes_per_rack=2,
                     gpus_per_node=8, oversubscription=FIG12_OVERSUB)
    topo, sched, pol = ScenarioSpec(fab, CollectiveSpec("a2a", FIG12_BYTES),
                                    FIG12_POLICY).build()
    if sched.n_flows != FIG12_FLOWS:
        raise AssertionError(f"fig12: {sched.n_flows} flows, expected "
                             f"{FIG12_FLOWS}")
    return topo, sched, pol


# fault_grid_dcqcn: Fig 13's scenario at paper scale
# (benchmarks/figures.py:239-301 at REPRO_BENCH_SCALE=paper): the 128-GPU
# 8-rack CLOS at oversubscription 2, a 1D all-reduce of 64 MB, PFC off;
# Fig 13(a)'s loss x recovery lanes, then Fig 13(b)'s flap lanes, as one
# run_batch of 8 lanes under DCQCN on the kernel path
FIG13_BYTES = 64e6
FIG13_FLOWS = 130048
FIG13_LOSS = (0.0, 1e-5, 1e-3)
FIG13_FLAP_PERIODS = (400e-6, 1600e-6)
FIG13_FLAP_DOWN = 100e-6
FIG13_CHECK_LANE = 3           # loss 1e-5, go-back-N


def fig13_lanes() -> dict:
    """The 8 lanes' stacked FaultSpec leaves (on top of ``pfc_on=0``):
    loss x gbn in the figure's grid order, then the two flap periods."""
    rows = [(loss, gbn, 0.0, 0.0) for loss in FIG13_LOSS
            for gbn in (0.0, 1.0)]
    rows += [(0.0, 0.0, p, FIG13_FLAP_DOWN) for p in FIG13_FLAP_PERIODS]
    cols = np.asarray(rows, np.float32).T
    return dict(zip(("loss_rate", "gbn", "flap_period", "flap_down"), cols))


def fig13_lane_fault(lane: int) -> dict:
    """Lane ``lane``'s FaultSpec fields as float32 values."""
    return {"pfc_on": 0.0, **{k: float(v[lane])
                              for k, v in fig13_lanes().items()}}


# faults_clos32: the 32-GPU 2D all-reduce under DCQCN with PFC on, IRN
# loss, half-strength ECN marking and every fabric link at half capacity
# over the middle third of the lossless run
FAULTS32_LOSSLESS = 0.002959999954327941     # REFERENCE clos32_2d dcqcn
FAULTS32_FAULT = {"loss_rate": 1e-4, "gbn": 0.0, "pfc_on": 1.0,
                  "ecn_scale": 0.5, "degrade": 0.5,
                  "degrade_t0": FAULTS32_LOSSLESS / 3,
                  "degrade_t1": 2 * FAULTS32_LOSSLESS / 3}

# mlp_heldout16: examples/learn_cc.py's held-out incast, every policy in
# one policy-axis batch (repro.learn.train.heldout_eval's engine config)
HELDOUT_GPUS, HELDOUT_SENDERS, HELDOUT_BYTES = 16, 15, 2e6
HELDOUT_CFG = dict(dt=2e-6, max_steps=4000, max_extends=4, queue_stride=0)
# lossy_step_check: the kernel-path step under faults held against the op
# path after this many steps of Fig 13's lanes
FIG13_STEP_AT = 300

# The JAX reference (jnp step, CPU), each as a serial run, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py \
#       fault_grid_dcqcn faults_clos32 mlp_clos128 mlp_heldout16
# (jax 0.9.0, numpy 2.0.2).  Completion within two steps, the same status,
# PAUSE frames rtol 1e-3 + 1, lost bytes rtol 1e-4.
FIG13_REFERENCE = {
    0: {"completion_time": 0.013303999789059162, "status": "ok",
        "lost": 0.0},
    1: {"completion_time": 0.013303999789059162, "status": "ok",
        "lost": 0.0},
    2: {"completion_time": 0.013088000006973743, "status": "ok",
        "lost": 593933.5625},
    3: {"completion_time": 0.013043999671936035, "status": "ok",
        "lost": 594094.8125},
    4: {"completion_time": 0.013307999819517136, "status": "ok",
        "lost": 59538728.0},
    5: {"completion_time": 0.013683999888598919, "status": "ok",
        "lost": 60669908.0},
    6: {"completion_time": 0.018751999363303185, "status": "ok",
        "lost": 0.0},
    7: {"completion_time": 0.013939999975264072, "status": "ok",
        "lost": 0.0},
}
FAULTS32_REFERENCE = {"completion_time": 0.005495999939739704,
                      "status": "ok", "pause_frames": 253.60000610351562,
                      "lost": 256058.875}
MLP_REFERENCE = {
    "clos128_1d": {"completion_time": 0.020243998616933823, "status": "ok",
                   "pause_frames": 266590.3125},
    "fig13_gbn": {"completion_time": 0.010103999637067318, "status": "ok",
                  "lost": 594031.25},
}
# examples/learn_cc.py's held-out incast, the reference's policy-axis batch
HELDOUT_REFERENCE = {
    "pfc": {"completion_time": 0.0012000000569969416, "status": "ok",
            "pause_frames": 1734.0},
    "dcqcn": {"completion_time": 0.0016240000259131193, "status": "ok",
              "pause_frames": 0.0},
    "dctcp": {"completion_time": 0.0012000000569969416, "status": "ok",
              "pause_frames": 0.0},
    "timely": {"completion_time": 0.0012000000569969416, "status": "ok",
               "pause_frames": 0.0},
    "hpcc": {"completion_time": 0.0013160000089555979, "status": "ok",
             "pause_frames": 0.0},
    "hpcc_pint": {"completion_time": 0.0012580000329762697, "status": "ok",
                  "pause_frames": 0.0},
    "static_window": {"completion_time": 0.0012000000569969416,
                      "status": "ok", "pause_frames": 0.0},
    "mlp": {"completion_time": 0.0012000000569969416, "status": "ok",
            "pause_frames": 0.0},
}

# autotune_incast8: examples/cc_autotune.py's scenario and settings (an
# 8-GPU single switch, a 7 x 10 MB incast, DCQCN), its CC tuning and its
# fabric tuning, each cut to its first 2 descent steps of 10 and 6 (one
# takes about 26 s on the card, and the third follows a gradient that is
# not reproducible: PERF.md)
AUTOTUNE_GPUS, AUTOTUNE_BYTES = 8, 10e6
AUTOTUNE_CFG = dict(dt=2e-6, max_steps=2200, max_extends=0)
AUTOTUNE_RUNS = {
    "cc": dict(tune_keys=["rai_frac", "rhai_frac", "g"], steps=2, lr=0.25,
               population=4),
    "fabric": dict(tune_keys=[], fabric_keys=["kmin", "kmax"], steps=2,
                   lr=0.3, population=3),
}
# learn_step: Adam steps of the mlp trainer on curriculum_default()
LEARN_STEPS = 1
# soft_grad: the gradient's keys (fabric.<field> for a FabricParams leaf)
SOFT_GRAD_KEYS = ("rai_frac", "g", "fabric.kmin")
# remat segment length of the 128-GPU gradient (PERF.md: chosen by
# measuring 100 and 300)
SOFT_GRAD_CHUNK = 100

# The JAX reference (CPU) for these three, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py \
#       autotune_incast8 learn_step soft_grad:clos32_2d
# (jax 0.9.0, numpy 2.0.2).  Losses rtol 1e-5, weights and gradients rtol
# 1e-3, the soft cost bit for bit; the tunings as compare_tune says.
AUTOTUNE_REFERENCE = {"cc": {"history": [{"step": 0,
                     "cost": 0.0017386175459250808,
                     "population_costs": [0.0018142336048185825,
                                          0.0017433405155315995,
                                          0.0017805378884077072,
                                          0.0017386175459250808],
                     "projected": [],
                     "nonfinite_members": [],
                     "rai_frac": 0.03267158940434456,
                     "rhai_frac": 0.06007659435272217,
                     "g": 0.004044985864311457},
                    {"step": 1,
                     "cost": 0.0016733489464968443,
                     "population_costs": [0.0016733489464968443,
                                          0.0024312317837029696,
                                          0.0023023427929729223,
                                          0.0016735399840399623],
                     "projected": [],
                     "nonfinite_members": [],
                     "rai_frac": 0.3654748499393463,
                     "rhai_frac": 0.6091246604919434,
                     "g": 0.0003206445253454149}],
        "baseline_cost": 0.0018142336048185825,
        "tuned_cost": 0.0016733489464968443},
 "fabric": {"history": [{"step": 0,
                         "cost": 0.0017284487839788198,
                         "population_costs": [0.0018142412882298231,
                                              0.0017284487839788198,
                                              0.0017672808608040214],
                         "projected": [],
                         "nonfinite_members": [],
                         "fabric.kmin": 446318.9375,
                         "fabric.kmax": 1330869.625},
                        {"step": 1,
                         "cost": 0.0014863661490380764,
                         "population_costs": [0.0017705147620290518,
                                              0.0018322623800486326,
                                              0.0014863661490380764],
                         "projected": [],
                         "nonfinite_members": [],
                         "fabric.kmin": 5564950.5,
                         "fabric.kmax": 21828676.0}],
            "baseline_cost": 0.0018142412882298231,
            "tuned_cost": 0.0014863661490380764}}
LEARN_REFERENCE = {"history": [{"loss": 2.5,
              "per_task": {"incast8": 0.0005157451378181577,
                           "ring16": 0.001940512447617948,
                           "incast8_lossy_irn": 0.0005178329884074628},
              "grad_norm": 1.49219732097982}],
 "weights": {"w1_00": 0.02514604421867866,
             "w1_01": -0.026420972658260378,
             "w1_02": 0.17808452164956776,
             "w1_03": 0.07097998701354599,
             "w1_04": -0.057133921098626805,
             "w1_05": 0.12231899102152291,
             "b1_0": 0.04999999705769703,
             "w1_10": 0.26080000902602746,
             "w1_11": 0.18941619262584844,
             "w1_12": -0.09074712824927893,
             "w1_13": -0.20308464534861936,
             "w1_14": -0.07465533948051438,
             "w1_15": 0.05826500408542572,
             "b1_1": 0.04999997172152667,
             "w1_20": -0.46500615492776687,
             "w1_21": -0.043758332786509146,
             "w1_22": -0.2991821791093156,
             "w1_23": -0.19645342626468132,
             "w1_24": -0.1588517396015522,
             "w1_25": -0.1132600068109127,
             "b1_2": -0.049999996394153326,
             "w1_30": 0.08232610727482657,
             "w1_31": 0.20850267388853552,
             "w1_32": -0.07570692434320946,
             "w1_33": 0.22329272978925968,
             "w1_34": -0.18303888924988532,
             "w1_35": 0.020302033525035686,
             "b1_3": -0.04999999712453452,
             "w2_00": 0.23069402576980577,
             "w2_01": -0.031197533476112708,
             "w2_02": -0.19869984523875822,
             "w2_03": -0.13434511049936865,
             "b2_0": -6.450000000529997,
             "w2_10": -0.04155420351250485,
             "w2_11": -0.00595502204422841,
             "w2_12": -0.2519196935107293,
             "w2_13": 0.00813544017087938,
             "b2_1": -0.9500004526836721}}
SOFT_GRAD_REFERENCE = {"clos32_2d": {"soft_cost": 0.0013953729066997766,
               "grad": {"rai_frac": -0.00022894320136401802,
                        "g": -0.00012396377860568464,
                        "fabric.kmin": -5.853551532375434e-10}}}

# campaign_atlas128: experiments/atlas/atlas_paper_ring128.csv, written by
# benchmarks/atlas.py at REPRO_BENCH_SCALE=paper through the reference's
# run_campaign: the 128-GPU 8-rack CLOS (oversubscription 2), the
# topology-aware ring all-reduce of 128 MB in one chunk (32,512 flows),
# one task per policy of its key parameter at x0.5, x1, x2 of the default
# (clipped to the ParamSpec) crossed with paired ECN ramps (kmin, 4*kmin)
# x xoff, 12 lanes a task.  Completion within 2 steps, PAUSE frames within
# rtol 1e-3 + 1, lane status equal.
ATLAS_CSV = REPO / "experiments" / "atlas" / "atlas_paper_ring128.csv"
ATLAS_KEY_PARAM = {"dcqcn": "rai_frac", "hpcc": "eta", "timely": "beta",
                   "mlp": "out_gain"}
ATLAS_SPAN = (0.5, 1.0, 2.0)
ATLAS_FABRIC = [(k, 4.0 * k, x) for k in (100e3, 1000e3)
                for x in (0.25e6, 4e6)]
ATLAS_BYTES = 128e6
ATLAS_CFG = dict(dt=4e-6, max_steps=6000, max_extends=6, queue_stride=0)
# the child SIGKILLs itself before dispatching its third chunk (one chunk
# a task), so the journal holds dcqcn's and hpcc's
ATLAS_KILL_BEFORE = 3
# campaign_ladder32: 4 DCQCN lanes of rai_frac on clos32_2d; the dispatch
# hook raises torch.OutOfMemoryError on the first 1, 2 attempts (the
# serial rung dispatches no chunk, so the hook never sees it)
LADDER_RAI = (0.015, 0.03, 0.06, 0.12)
# (failures injected, the rungs they must walk, whether the runner lays
# its lanes over a mesh of the card twice: only there the no_mesh rung
# applies)
LADDER_CASES = ((1, ["half_chunk"], False),
                (2, ["half_chunk", "serial"], False),
                (2, ["half_chunk", "no_mesh"], True))
# predict32: tests/test_system.py's collective mix replayed on the
# reference's default 32-GPU CLOS (src/repro/core/predict.py's default)
PREDICT_OPS = (("all-reduce", 64e6, 16, 16), ("all-to-all", 16e6, 16, 16))
PREDICT_MESH, PREDICT_AXES = (16, 16), (0, 1)
PREDICT_DT = 2e-6
# The JAX reference (CPU, serial runs) from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py predict32
# (jax 0.9.0, numpy 2.0.2): 15,488 flows.  Within 2 steps; PAUSE frames
# rtol 1e-3 + 1.
PREDICT_REFERENCE = {
    "pfc": {"comm_time": 0.000800000037997961, "pauses": 0.0},
    "dcqcn": {"comm_time": 0.0009060000302270055, "pauses": 0.0},
    "dctcp": {"comm_time": 0.000800000037997961, "pauses": 0.0},
    "timely": {"comm_time": 0.002114000031724572, "pauses": 0.0},
    "hpcc": {"comm_time": 0.000994000001810491, "pauses": 0.0},
    "hpcc_pint": {"comm_time": 0.0013640000252053142, "pauses": 0.0},
    "static_window": {"comm_time": 0.0008960000122897327, "pauses": 0.0},
    "mlp": {"comm_time": 0.000800000037997961, "pauses": 0.0},
}


def atlas_csv() -> list:
    """The committed atlas's rows, numbers parsed."""
    import csv
    with open(ATLAS_CSV, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for k in ("param_value", "kmin", "kmax", "xoff", "completion_ms"):
            r[k] = float(r[k])
        r["pfc_frames"] = int(r["pfc_frames"])
    return rows


def atlas_lanes(policy) -> tuple:
    """A policy's atlas lanes, as ``benchmarks/atlas.py`` builds them:
    ``(key, (12,) float32 values, stacked fabric dict)``; ``policy`` is
    either package's ``Policy``."""
    key = ATLAS_KEY_PARAM[policy.name]
    spec = policy.param_spec(key)
    vals = [min(max(spec.default * s, spec.lo), spec.hi) for s in ATLAS_SPAN]
    lanes = [(v, f) for v in vals for f in ATLAS_FABRIC]
    pts = np.asarray([f for _, f in lanes], np.float32)
    return (key, np.asarray([v for v, _ in lanes], np.float32),
            {"kmin": pts[:, 0], "kmax": pts[:, 1], "xoff": pts[:, 2]})


# dlrm_reference: Table II widths with small tables, weights from numpy
DLRM_REF_ROWS = 8192
DLRM_REF_SEED = 0
DLRM_REF_BATCH = 64
DLRM_REF_RTOL, DLRM_REF_ATOL = 2e-2, 2e-3
# its logits by the JAX reference (jnp embedding path, and the Pallas one
# in interpret mode: equal), from the same script (jax 0.9.0, numpy 2.0.2)
DLRM_REF_LOGITS = [
    -1.7109375, -1.6875, -1.640625, -1.796875, -1.8828125, -1.75, -1.734375,
    -1.4765625, -1.640625, -1.8515625, -1.8828125, -1.8828125, -1.796875,
    -1.6328125, -1.65625, -1.640625, -1.8515625, -1.8203125, -1.7421875,
    -1.5625, -1.9140625, -2.15625, -1.8984375, -1.71875, -2.3125, -1.6875,
    -1.9609375, -2.109375, -1.5703125, -1.4375, -1.8671875, -1.9453125,
    -1.7578125, -1.5859375, -1.9765625, -1.640625, -1.8828125, -1.8359375,
    -1.640625, -1.5625, -1.515625, -1.5390625, -1.65625, -1.34375, -2.296875,
    -1.75, -1.9609375, -1.5625, -2.109375, -1.7734375, -1.703125, -1.625,
    -1.5859375, -1.65625, -1.640625, -1.859375, -1.578125, -1.3828125,
    -2.171875, -1.8671875, -1.8125, -1.96875, -1.8125, -2.046875,
]

# serve_long: the flash-decode kernel on a realistic cache
SERVE_SEED = 0
SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 8, 2048, 64
SERVE_MAX_LEN = 32768          # decode_32k's cache (src/repro/configs/shapes.py)
SERVE_REL_L2 = 2e-2            # kernel path vs torch path, per step
# the depth SERVE_REL_L2 was set at (TinyLlama's 22 layers).  Two decode
# paths that differ anywhere by an ulp drift apart as a random walk of the
# bf16 residual stream's roundings (each add rounds differently once the
# paths differ), so their distance grows as sqrt(depth): at Gemma-2's 42
# layers the kernel path lies 2.0% from its own plain version in its
# place, as far as from the torch path (PERF.md, PR 21)
SERVE_REL_L2_DEPTH = 22

# serve_reference: TinyLlama's widths, depth cut to 4 layers so that the JAX
# reference runs on a CPU; numpy weights at the true fan-in
SERVE_REF_SEED = 1
SERVE_REF_LAYERS = 4
SERVE_REF_ROWS, SERVE_REF_PROMPT, SERVE_REF_STEPS = 4, 32, 8
SERVE_REF_IDS = [int(i) for i in np.linspace(0, 31999, 16)]
SERVE_REF_ATOL, SERVE_REF_REL_L2, SERVE_REF_LSE_ATOL = 0.15, 3e-2, 1e-2
# the reference's logits (prefill's last position, then each decode step;
# rows of 4) at SERVE_REF_IDS, log-sum-exp, top-1 id and top-2 margin, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py serve_reference
# (jax 0.9.0, numpy 2.0.2), rounded to 5 decimals
SERVE_REF = {
    "logits":
    [[[-1.05716, 0.01842, -1.33402, 0.2048, 0.13431, -1.71034, -0.38183,
     0.62529, -1.37133, 0.79467, 1.12023, -0.11884, -0.91325, -1.16844,
     -0.2915, -1.74228], [-1.09405, 0.02597, -0.06192, -1.61375, -0.97028,
     0.1416, -1.15539, 1.2254, 0.29827, 1.01407, 0.2878, 0.97062, 0.73753,
     0.07736, 1.44894, -1.03541], [-1.32633, 0.15206, -0.94769, -0.41453,
     0.25911, -0.46166, 0.36549, -1.60381, -0.35059, -0.75017, 1.7059,
     0.56563, 0.58923, 2.00892, 0.3694, 0.31325], [-0.40828, 0.57739,
     -0.23296, -1.21405, -0.47172, 1.51549, 1.05029, 0.90737, 1.36547,
     -0.68216, 1.73708, -1.81365, 1.06872, 1.94586, 0.66904, -0.63547]],
     [[-0.86214, 0.16006, -1.19997, -0.60456, 1.09288, 1.1544, -0.05583,
     -0.4158, -2.0107, 0.93204, 0.82675, -0.46706, -2.41779, 0.6542,
     -0.59912, -1.73205], [-0.01451, 0.36967, -1.7772, -1.95928, 0.12855,
     -0.93692, -0.10777, 0.44186, 1.03645, 0.36441, 0.3269, 1.81695,
     0.07621, 0.30646, 1.46144, -1.59604], [-0.84789, 0.03684, -0.38028,
     -0.0902, 0.44184, -0.43877, -1.3401, -0.87353, -0.45304, -0.16018,
     2.30153, 0.33581, 1.40424, 1.28834, 1.85779, -1.05745], [0.4497,
     -1.41677, 0.33739, -0.6741, -1.12458, 0.46215, 0.30505, -0.02629,
     0.97017, 0.16591, 1.04602, -1.65465, 2.27909, 2.09003, 0.6034,
     -0.36874]], [[-1.31144, -1.07558, 1.18316, -0.97101, -0.86015,
     -0.37257, 0.59686, -0.61253, -2.02561, -0.01001, 0.55408, -0.15168,
     -0.67455, 0.06749, -0.86363, -1.61864], [-0.64018, 0.27967, 0.23532,
     -1.00214, -0.10336, 0.08154, -1.16525, 0.84875, -1.14946, 0.27009,
     -0.16886, 2.64437, 1.13691, 0.16142, 1.48742, -0.05645], [-0.59038,
     0.4897, -0.07706, -0.58021, 0.20513, -0.56154, 0.65117, -1.9023,
     -0.62139, -0.31739, 1.85102, -0.74371, 0.88061, 2.59134, 0.5919,
     0.14888], [0.15059, -0.01099, 0.72497, -0.17376, -1.16664, 1.08678,
     0.36968, -0.68237, 0.22259, -1.09817, 1.43136, -1.62936, 2.41214,
     0.9376, -0.17406, -1.38086]], [[-1.62389, -0.52557, -0.33608,
     -1.09883, 0.16888, -0.30787, 1.21833, -0.41121, -1.87936, -0.46609,
     0.80178, 1.18767, -1.36909, 0.15475, -0.02514, -1.0947], [0.88844,
     1.61847, -0.45977, 0.20742, -0.85325, 0.82392, 0.01805, 1.12399,
     0.93206, 0.8654, 1.028, 2.02694, 1.1415, 0.40842, 0.38285, 0.3538],
     [0.43617, 0.54713, -0.81762, 0.06825, -0.77474, -1.27701, 0.07802,
     -0.6213, 0.43047, -1.48574, 0.81239, -0.41203, -1.25795, 1.63826,
     0.67879, -0.54382], [0.59905, -1.06551, 0.44068, -0.53741, 0.20343,
     0.42598, 0.5902, 1.52752, 0.06194, -0.40697, -0.43958, -0.73167,
     0.44729, 0.79471, -0.2868, -0.86802]], [[-1.94264, 0.48123, 0.24224,
     -0.24445, -0.50182, -0.27295, -0.03093, -1.22602, -1.67337, 0.53097,
     1.53258, 0.79726, -1.01627, 0.24965, -0.38099, -0.58698], [-0.59414,
     1.23378, -0.1011, 0.03664, -0.6469, -1.11289, -1.38769, 2.56481,
     0.46088, 0.08501, 0.60698, 2.37206, 0.09142, -0.04869, 2.3281,
     0.85891], [-0.99659, 1.30059, -0.67808, 0.50066, 0.47824, -0.0271,
     0.43408, -0.0449, 0.35767, -0.4879, 0.66323, 0.11818, 0.73395,
     1.45182, -1.30375, -1.09392], [0.09766, -0.0149, -0.04884, -1.38753,
     -0.25123, 0.1446, 0.4881, 1.4022, 0.19729, -1.14827, 0.27352,
     -0.58861, 1.15213, -0.31504, -0.24939, -1.01618]], [[-0.62838,
     0.26494, -0.23566, -0.11612, 0.95955, -1.20277, 0.90565, -0.52645,
     -1.50824, 0.52218, 0.73705, 1.08049, -0.98573, 0.67129, -0.89978,
     -0.72596], [-0.28158, 1.377, 1.33602, -1.00945, -1.99206, -0.65035,
     -0.89156, 1.14494, 1.27717, 0.86785, 0.40917, 1.20795, 0.43188,
     -0.88293, 0.53458, 0.38156], [0.47075, 0.16124, -1.38247, -0.85851,
     1.0553, -1.11237, -0.64013, -1.37656, 0.62203, -0.65859, 1.56977,
     -0.4066, 0.37308, 1.8688, 0.95562, -0.0689], [1.18251, -1.03854,
     -0.16593, -0.65863, -0.52369, 0.8383, 1.39151, 0.2126, 0.03455,
     -0.38859, 1.14168, 0.48954, 1.35373, 0.08233, -0.17911, -0.2243]],
     [[-0.57648, -0.59017, -0.66877, 1.32931, 0.5859, 0.08993, -0.47549,
     0.3098, -2.43229, 1.19083, 2.05203, 0.87844, -1.60846, -0.91685,
     -0.60022, -0.41987], [-0.82606, 0.01117, -0.35085, -0.08858,
     -1.49839, 0.00358, -0.84387, 1.21168, 0.97615, 0.60732, 0.80235,
     0.58405, 2.01509, 0.60154, 1.35607, 0.63941], [-0.75013, -0.01201,
     -2.44022, 0.30619, -1.03582, 0.003, -1.56053, -1.74333, -0.60895,
     -0.9981, 0.65294, -0.30255, -0.2115, 2.08056, 1.19386, -2.25866],
     [1.13733, -0.02763, -0.99264, -1.13755, -1.38754, 0.24834, -0.42198,
     0.93869, 0.42111, -1.09755, 0.57569, -1.49349, 1.73977, 1.97928,
     -1.59185, -0.84282]], [[-1.0192, 0.08443, 0.81661, -0.18836,
     -0.43008, -0.93809, 0.25058, 0.20849, -1.94648, 1.99216, 1.0137,
     1.15658, -1.17948, 0.34436, 0.33019, -0.73392], [0.27057, -0.42885,
     0.04045, 0.17149, -0.78018, -1.21155, 0.80082, 2.54399, 0.71511,
     0.92256, -0.03841, 0.06643, 1.09176, -0.31725, 1.79455, 0.72613],
     [-0.62559, 0.06383, -0.97622, 0.16955, 1.68536, -2.02095, 0.4126,
     0.04298, 0.84308, -0.33526, 0.46139, 0.58809, 1.00908, 0.78056,
     0.90037, -0.29419], [1.40597, -0.25182, 0.58927, -1.97787, -1.25349,
     0.78367, 0.61662, -0.17057, 0.80918, -0.85201, 2.21574, -1.28207,
     1.63599, 1.72257, -0.83887, -0.09732]], [[-1.33878, -0.1028,
     -0.80917, -0.1309, -0.24251, -2.87359, 1.40857, 0.95682, -2.05041,
     -0.2577, 2.24055, -0.05796, -1.90105, -0.87053, -0.14115, -1.23183],
     [-0.23038, -0.01485, 0.6031, 0.02999, -0.16517, -0.57164, -0.09929,
     0.78014, -1.32259, -0.418, 0.73893, 1.07307, 0.54439, 0.36939,
     0.61705, 0.14007], [0.07114, 1.04989, -0.30185, 1.13551, 1.55466,
     -1.24893, -0.80581, -0.77187, 1.2004, -0.34326, 1.03751, 1.28374,
     -0.01877, 1.26389, 1.09699, -0.85444], [0.4254, -0.1792, -0.39858,
     0.08765, -0.71892, -0.13087, 0.80908, 0.19388, -0.73566, -2.00779,
     0.07442, -0.29046, 2.10816, 0.99275, 0.27064, -1.37786]]],
    "lse":
    [[10.88015, 10.87922, 10.88729, 10.88469], [10.8786, 10.8791,
     10.87927, 10.88097], [10.882, 10.88493, 10.88091, 10.88271],
     [10.88016, 10.87677, 10.8833, 10.87906], [10.87164, 10.8838,
     10.89502, 10.88124], [10.88724, 10.88482, 10.88285, 10.89642],
     [10.89467, 10.87503, 10.87701, 10.87966], [10.87229, 10.8825,
     10.87594, 10.86608], [10.8783, 10.88778, 10.88047, 10.8798]],
    "top1":
    [[6992, 4791, 31665, 38], [26913, 21702, 18918, 17661], [7596, 1001,
     14675, 973], [13893, 20124, 25879, 14119], [15209, 13194, 30207,
     17220], [30457, 1375, 25879, 7473], [29107, 18928, 19011, 18707],
     [10718, 16175, 8941, 23232], [20128, 19411, 23340, 12431]],
    "margin":
    [[0.08116, 0.45732, 0.09521, 0.28271], [0.07464, 0.29757, 0.2469,
     0.03263], [0.02961, 0.29736, 0.05377, 0.04858], [0.22755, 0.13772,
     0.3935, 0.14268], [0.21591, 0.27738, 0.10384, 0.15474], [0.05081,
     0.27055, 0.24194, 0.00178], [0.05257, 1.05739, 0.03454, 0.97852],
     [0.2841, 0.95706, 0.40096, 0.19393], [0.00286, 0.54636, 0.68281,
     0.12032]],
}


# serve_gemma2 / serve_gemma3 / serve_phi4: each config through ServeEngine
# on the card at full width, hashed weights at the true fan-in, 2 slots.
# Gemma-2 at full depth with a prompt of its window + 256 (the prefill
# takes local_attention's chunks, and the ring wraps at the fill), Gemma-3
# cut to two of its 5:1 periods the same way; the blockwise prefill's
# global layers at tiles of 256 (the prompts are no multiple of 512).
# Phi-4-mini at full depth on a 2,048-token prompt (global layers only)
SERVE_ARCHS = {
    "gemma2-9b": {"phase": "serve_gemma2", "layers": None, "prompt": 4352,
                  "new": 64, "max_len": 8192, "block": 256},
    "gemma3-27b": {"phase": "serve_gemma3", "layers": 12, "prompt": 1280,
                   "new": 64, "max_len": 2048, "block": 256},
    "phi4-mini-3.8b": {"phase": "serve_phi4", "layers": None,
                       "prompt": 2048, "new": 32, "max_len": 4096,
                       "block": None},
    # Zamba2 at full depth: 38 Mamba-2 layers, the shared GQA block after
    # every 6 (6 applications, the kernel's launches); a 2,048-token prompt
    # takes the shared block's blockwise prefill.  ``resync``: each step's
    # plain and torch paths start from the kernel path's cache, as the
    # recurrent states carry a step's rounding into every later one
    "zamba2-1.2b": {"phase": "serve_zamba2", "layers": None, "prompt": 2048,
                    "new": 64, "max_len": 2176, "block": None,
                    "resync": True},
}
SERVE_ARCH_SLOTS = 2
# serve_int8: TinyLlama at full width and depth with the int8 KV cache
# (the reference's kvquant knob, src/repro/launch/dryrun.py:78-79) on
# serve_long's shape; the kernel's int8 instantiation timed on the last
# step's captured inputs of layers 21 and 0
SERVE_INT8 = {"phase": "serve_int8", "arch": "tinyllama-1.1b",
              "layers": None, "prompt": SERVE_PROMPT, "new": SERVE_NEW,
              "max_len": SERVE_MAX_LEN, "block": None, "slots": SERVE_SLOTS,
              "over": {"kv_quant_int8": True}, "capture": (0, 21)}
# the mixers whose decode attention is the flash-decode kernel
KERNEL_MIXERS = ("gqa_g", "gqa_l", "shared_gqa")
# serve_rwkv6, serve_deepseek: no kernel on their decode path (the
# reference has none for RWKV-6, MLA or MoE); RWKV-6 at full depth on a
# 512-token prompt (the token scan), then its prefill in chunks of 64;
# DeepSeek-V2 and -V3 at full width, depth cut to 4 (V2: 1 dense + 3 MoE
# layers, about 26.6 GB of bf16 weights; V3: 3 dense + 1 MoE, about 30 GB),
# loaded one after the other
SERVE_FAMILIES = {
    "rwkv6-3b": {"phase": "serve_rwkv6", "layers": None, "prompt": 512,
                 "new": 64, "max_len": 640, "chunk": 64},
    "deepseek-v2-236b": {"phase": "serve_deepseek", "layers": 4,
                         "prompt": 512, "new": 32, "max_len": 1024},
    "deepseek-v3-671b": {"phase": "serve_deepseek", "layers": 4,
                         "prompt": 512, "new": 32, "max_len": 1024},
}
SERVE_FAMILY_REL_L2 = 3e-2     # each decode step vs a teacher-forced prefill
RWKV_CHUNK_TOL = 2e-3          # chunked vs scan time mix (tests/test_blocks.py)

# serve_sliding_reference: Gemma-2 and Gemma-3 at full width, depth one
# attention period (Gemma-2's local + global, Gemma-3's 5 local + 1
# global), the window cut to 24 so that serve_reference's 32-token prompts
# take local_attention and fill the ring wrapped, and its 8 decode steps
# wrap it again; hashed_params from SERVE_REF_SEED; the vocabulary not
# cut.  The reference's logits from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py sliding_reference
# (jax 0.9.0, numpy 2.0.2), rounded to 5 decimals, at serve_reference's
# tolerances
SLIDING_REF_WINDOW = 24
SLIDING_REF = {
    "gemma2-9b": {
        "logits":
        [[[-0.01803, -0.02644, -0.01667, -0.01609, -0.01696, -0.00739,
        0.00565, 0.00066, 0.03912, -0.01955, 0.01355, -0.03598, -0.00085,
        0.02263, 0.00783, 0.02311], [-0.02812, -0.04758, 0.02888, -0.00863,
        -0.02034, -0.0193, -0.02679, 0.01212, -0.02209, -0.01403, -0.02142,
        0.01053, -0.02491, 0.05679, 0.01969, 0.0168], [0.02917, -0.02895,
        -0.03163, -0.0317, -0.01544, -0.02125, 0.02489, 0.0124, -0.0163,
        0.03525, -0.02519, -0.00091, -0.01795, -0.01638, -0.00495, 0.03874],
        [0.02228, -0.00596, -0.00106, 0.00771, -0.01424, -0.01803, 0.00282,
        -0.01419, -0.00175, -0.04466, 0.02258, 0.00483, -0.01552, 0.01555,
        -0.00835, -0.02704]], [[-0.03001, -0.00658, -0.01216, -0.02967,
        -0.00858, -0.02833, -0.01772, -0.01602, 0.0099, -0.04587, -0.0237,
        0.00182, 0.03217, -0.02276, 0.03957, 0.01405], [-0.02566, -0.02166,
        0.00571, -0.00218, -0.01689, -0.02542, -0.00819, -0.02388, 0.00827,
        -0.01056, 0.00503, 0.04154, -0.02102, 0.05713, 0.01085, 0.02992],
        [0.0202, -0.00662, -0.02848, -0.01307, -0.0115, -0.01053, -0.00722,
        0.02508, -0.00552, 0.02905, 0.01506, -0.02749, -0.00157, -0.01107,
        0.00407, -0.00154], [0.00309, 0.00771, -0.00613, -0.00046, -0.04293,
        -0.02304, 0.01102, -0.01769, 0.00725, -0.02173, 0.06241, -0.02899,
        -0.00787, -0.00352, -0.00619, -0.02097]], [[0.00033, 0.00855,
        -0.02587, -0.03549, -0.0066, -0.01299, -0.00121, 0.01523, 0.03399,
        -0.03652, -0.0085, 0.00437, -0.01891, -0.01584, -0.0007, -0.03635],
        [-0.02007, 0.00961, 0.00439, -0.01319, 0.00117, -0.01528, -0.01923,
        0.00024, -0.00223, 0.01355, 0.01524, 0.03189, -0.01704, -0.00595,
        -0.01243, 0.00451], [0.01461, 0.00154, -0.02066, 0.00919, 0.0276,
        0.01417, -0.02439, 0.0227, -0.00641, 0.02206, 0.01149, -0.01604,
        0.01361, 0.02354, 0.0249, 0.04049], [0.01353, -0.00908, -0.00187,
        0.01752, -0.02691, -0.0143, 0.01212, 0.01559, -0.00785, -0.0079,
        0.01131, -0.02551, -0.00913, -0.01453, -0.01453, -0.00299]],
        [[-0.00491, 0.00681, -0.00136, 0.00021, 0.01067, -0.02629, -0.01709,
        -0.0029, 0.01585, -0.02533, -0.00365, -0.01169, 0.02122, -0.01493,
        -0.00876, -0.02185], [-0.04996, -0.00721, 0.0235, -0.02694,
        -0.00915, -0.03656, 0.0112, 0.01496, 0.01024, -0.02735, -0.03074,
        0.02529, 0.01082, 0.02047, -0.02275, 0.02741], [0.03504, -0.00902,
        -0.0296, -0.0152, -0.01676, 0.01446, 0.01303, 0.02244, 0.00105,
        -0.04685, -0.03864, 0.02006, -0.02098, -0.00696, 0.00745, -0.02187],
        [0.01638, 0.02208, -0.00978, -0.01477, -0.01894, -0.00159, 0.02017,
        0.02123, 0.01518, -0.02151, 0.00997, -0.00342, -0.01298, -0.02176,
        -0.02121, -0.03556]], [[-0.02308, -0.01362, -0.00047, 0.01738,
        0.01102, -0.01895, -0.00683, -0.00656, -0.00664, -0.01501, -0.02289,
        0.00804, -0.00508, -0.01802, 0.03085, -0.01908], [-0.00797, 0.00697,
        -0.02598, 0.00767, 0.00504, -0.00835, 0.01274, -0.00693, -0.00785,
        -0.01665, 0.01734, 0.01621, -0.00177, 0.00232, -0.02734, 0.0143],
        [0.03207, -0.01374, -0.01351, 0.01253, -0.00314, 0.01587, 0.0145,
        0.00467, 0.01121, 0.02484, -0.0461, -0.01215, 0.00988, 0.00345,
        -0.01098, 0.00802], [-0.02023, 0.01665, 0.02337, -0.0127, -0.04289,
        -0.02516, -0.00252, 0.01359, -0.01268, -0.02453, 0.02416, 0.00115,
        -0.00417, -0.02506, 0.01103, -0.02592]], [[-0.00319, -0.00042,
        0.01186, -0.01501, 0.01856, -0.03924, 0.01574, 0.00635, 0.03784,
        -0.00449, -0.01842, 0.00597, 0.01248, -0.0364, -0.02152, 0.0222],
        [-0.02584, -0.02558, -0.0046, -0.00693, -0.03799, -0.02609, -0.0139,
        -0.00577, -0.04315, 0.02311, -0.01085, -0.0145, -0.00836, 0.01004,
        -0.01026, 0.01189], [0.02019, 0.00811, 0.01601, -0.00586, 0.01939,
        -0.00035, 0.00486, -0.00786, 0.02134, 0.01304, 0.0064, 0.01259,
        -0.01377, 0.03665, -0.01424, -0.00786], [0.02478, 0.00965, -0.04386,
        -0.00075, 0.02128, -0.00021, 0.00723, 0.00058, 0.01755, -0.02743,
        0.04776, -0.04282, -0.01796, 0.00041, -0.00864, -0.00359]],
        [[0.01737, -0.05763, -0.00323, 0.02367, -0.02699, -0.03178,
        -0.02218, 0.00618, 0.01829, -0.00813, 0.00369, 0.01725, 0.0137,
        -0.01584, -0.00133, 0.00225], [-0.00444, -0.00499, 0.00324, -0.0055,
        -0.00926, -0.01782, -0.00765, -0.01155, -0.00688, -0.03398,
        -0.02688, 0.03409, -0.00194, 0.00353, -0.03526, 0.01811], [0.00924,
        0.00545, -0.01985, 0.0144, -0.007, -0.01639, -0.02058, -0.01175,
        -0.00671, 0.02621, -0.01009, 0.00255, -0.00442, 0.02086, 0.02857,
        0.00858], [-0.02025, -0.00111, -0.01742, 0.01748, -0.0192, -0.0018,
        -0.00561, 0.02204, 0.00944, -0.00876, 0.00796, -0.00813, 0.00225,
        -1e-05, -0.00189, -0.01315]], [[-0.01234, -0.01133, 0.01129,
        0.00308, -0.01624, 0.02887, -0.02167, 0.01274, 0.02204, -0.01132,
        -0.00535, 0.02376, -0.01202, 0.00285, 0.01051, -0.00386], [0.01418,
        -0.02522, -0.0156, 0.00456, -0.01922, -0.04206, -0.00161, -0.0186,
        -0.03739, 0.0083, -0.00563, 0.01777, -0.0125, -0.0093, 0.013,
        0.01109], [0.01225, -0.01352, -0.01304, -0.00725, -0.01265,
        -0.01592, 0.00409, -0.00513, 0.02425, 0.01367, -0.00391, 0.01042,
        -0.00269, -0.00844, 0.02544, 0.01375], [-0.02246, -0.00314,
        -0.02345, 0.01915, -0.00677, -0.01239, 0.00096, 0.02163, -0.02073,
        -0.01367, 0.01916, -0.00467, -0.02094, 0.00022, -0.02961,
        -0.00188]], [[-0.01969, -0.03216, -0.00614, 0.00066, 0.01111,
        0.00842, 0.01793, -0.01024, 0.03146, -0.02464, -0.0039, -0.03629,
        -0.00602, -0.00582, -0.01081, -0.00037], [-0.02728, -0.00611,
        0.01299, -0.00427, -0.01778, -0.02749, -0.02174, 0.01403, 0.00349,
        -0.00135, -0.02564, 0.02163, 0.0139, 0.01014, -0.0158, 0.01916],
        [0.00546, -0.00388, -0.00766, -0.00827, 0.00929, 0.01475, 0.00959,
        -0.0189, 0.00952, -0.00514, -0.00264, 0.01415, 0.00291, 0.00361,
        0.02554, -0.01573], [-0.00756, 0.05768, -0.01526, 0.00481, -0.0218,
        -0.01952, 0.01063, 0.00849, -0.01594, 0.0254, 0.01497, 0.01,
        -0.00055, 0.00136, -0.04476, 0.00314]]],
        "lse":
        [[12.45308, 12.45313, 12.45316, 12.45307], [12.45313, 12.45315,
        12.45313, 12.45314], [12.45313, 12.45311, 12.45308, 12.45309],
        [12.45313, 12.45307, 12.45316, 12.45308], [12.45312, 12.45321,
        12.45313, 12.45311], [12.45314, 12.45316, 12.45315, 12.45309],
        [12.45307, 12.45315, 12.45314, 12.45315], [12.45306, 12.4532,
        12.4532, 12.45302], [12.45312, 12.45314, 12.45312, 12.45313]],
        "top1":
        [[116095, 234828, 20877, 6269], [250087, 109392, 56319, 125369],
        [34314, 10135, 218938, 172405], [98127, 183943, 170912, 115981],
        [103196, 135318, 220488, 235286], [231391, 223256, 215043, 243338],
        [52084, 117589, 224393, 211667], [128578, 94228, 79498, 118891],
        [67152, 15961, 120808, 226693]],
        "margin":
        [[0.5078, 0.47732, 0.52662, 0.48657], [0.54482, 0.51545, 0.51648,
        0.52695], [0.495, 0.53497, 0.52995, 0.51561], [0.51387, 0.55231,
        0.53416, 0.49571], [0.53578, 0.51407, 0.51631, 0.50859], [0.50263,
        0.50901, 0.53142, 0.54262], [0.5276, 0.5051, 0.53431, 0.533],
        [0.503, 0.53319, 0.48171, 0.52099], [0.52676, 0.51494, 0.52848,
        0.53038]],
    },
    "gemma3-27b": {
        "logits":
        [[[0.02535, -0.0011, -0.01415, -0.00423, -0.01788, 0.01136,
        -0.00037, -0.0127, -0.02591, -0.01989, -0.01667, -0.03154, -0.0007,
        -0.02292, 0.02575, 0.00693], [0.02181, 0.01836, 0.03181, -0.00204,
        -0.02919, -0.01927, -0.02096, -0.00079, -0.01923, -0.00499,
        -0.02218, -0.00253, -0.01856, 0.00678, -0.02917, -0.03071],
        [-0.03129, 0.03091, 0.00098, 0.0263, -0.00106, -0.03101, -0.04126,
        -0.00093, -0.01114, -0.01964, 0.01177, 0.02668, 0.02181, -0.00702,
        -0.01834, -0.04661], [0.00248, -0.00373, -0.00704, -0.01381,
        0.00338, 0.00919, -0.00386, 0.00452, 0.02353, -0.00257, -0.00871,
        0.03458, 0.01441, 0.00717, -0.00472, 0.02284]], [[-0.00724,
        -0.00118, -0.00251, -0.00557, -0.02716, 0.0052, -0.01755, -0.01695,
        -0.00239, 0.03614, -0.0387, -0.03814, 0.01393, -0.04794, 0.01571,
        0.01675], [0.01495, -0.00585, 0.01621, 0.00543, 0.00718, -0.02564,
        -0.03847, 0.02944, -0.01365, -0.0165, -0.02065, -0.01767, -0.01879,
        0.01125, -0.01125, -0.00272], [-0.04762, 0.00915, -0.01207, 0.03036,
        -0.02073, -0.03364, -0.06027, 0.00599, 0.00373, 0.02831, -0.00668,
        -0.03577, 0.00329, -0.01559, -0.01744, 0.02478], [-0.03793,
        -0.02009, 0.04317, -0.00292, 0.00045, -0.03897, -0.00159, 0.00768,
        0.03725, -0.02845, 0.01227, 0.0222, -0.0058, -0.00786, 0.00793,
        -0.02617]], [[0.02033, 0.03495, -0.00568, -0.01205, -0.00902,
        0.0297, -0.00751, -0.02858, -0.03882, 0.01082, -0.01895, -0.01988,
        0.0197, -0.01922, 0.02623, 0.00219], [0.0382, 0.02196, 0.05114,
        -0.00652, -0.01401, 0.03425, -0.00553, 0.02574, -0.00684, -0.0125,
        -0.00457, -0.01085, -0.03227, 0.00459, -0.00372, -0.0053],
        [-0.03604, 0.03176, 0.00289, 0.00825, 0.01118, -0.0277, -0.00922,
        -0.00356, 0.00764, 0.00782, 0.03183, -0.03536, 0.02721, 0.00767,
        -0.01556, -0.03497], [-0.02708, -0.01709, 0.00765, 0.00184, -0.009,
        -0.01249, 0.0205, 0.01537, 0.00659, 0.00047, 0.01567, 0.01421,
        0.01652, 0.00538, -0.02894, 0.02084]], [[0.01038, -0.00044,
        -0.03151, -0.00194, -0.01558, -0.00759, -0.00228, -0.00786, -0.0157,
        0.05059, -0.01757, -0.02839, 0.00326, -0.02296, -0.00316, 0.01109],
        [0.03086, 0.01777, 0.04407, 0.03226, 0.00089, 0.00171, -0.03407,
        0.02471, -0.02668, -0.00507, -0.0357, 0.01329, -0.02436, -0.00885,
        -0.01116, -0.04609], [-0.03795, 0.02403, 0.00452, 0.01543, 0.00659,
        0.00024, -0.0237, -0.0081, -0.00237, -0.00313, 0.00467, 0.00061,
        0.01076, -0.02789, 0.03338, -0.01963], [0.00069, -0.01317, -0.03128,
        0.00043, 0.02416, 0.01156, 0.03576, 0.00819, 0.0194, -0.01242,
        0.02682, 0.00729, 0.02504, -0.01225, 0.00146, 0.00243]], [[-0.00793,
        0.01376, 0.0005, 0.00789, -0.02524, 0.00656, -0.01086, -0.03499,
        0.00571, 0.01282, 0.0081, -0.02162, 0.01157, -0.01931, -0.013,
        0.0303], [0.03175, 0.03403, 0.03964, 0.02453, -0.00185, -5e-05,
        0.01426, 0.02441, -0.03256, -0.03405, -0.02572, -0.01058, -0.04029,
        0.01787, -0.01688, -0.01076], [0.00664, -0.01256, -0.00048, 0.00581,
        -0.02151, 0.0008, 0.01447, -0.01231, -0.01466, 0.02012, 0.05267,
        -0.01805, 0.02316, -0.00929, 0.00568, 0.00416], [0.02211, -0.00218,
        -0.01222, 0.0041, -0.01523, 0.03021, 0.03894, 0.00209, 0.02184,
        -0.02578, 0.02359, 0.00163, 0.00892, 0.0169, -0.00389, 0.0014]],
        [[0.01853, 0.03702, -0.01372, 0.01296, -0.01707, 0.01101, -0.00739,
        -0.03016, 0.02165, -0.00523, -0.00695, -0.01758, 0.00125, -0.02481,
        0.01596, 0.02006], [-0.00468, 0.00156, 0.00917, 0.03719, -0.02876,
        0.00797, -0.01683, -0.00211, -0.05412, -0.00405, -0.03206, -0.00734,
        -0.03047, -0.00786, 0.01218, 0.00543], [-0.02814, 0.01381, 0.0119,
        -0.02031, 0.01121, -0.02425, -0.00667, -0.03293, 0.00515, 0.03265,
        0.01744, 0.00861, 0.00198, -0.03091, 0.00453, 0.04379], [0.00636,
        -0.03103, 0.00871, 0.01325, -0.00472, 0.01524, 0.0515, 0.00049,
        0.02985, -0.0012, 0.01082, -0.01918, -0.01697, 0.00393, -0.00038,
        -0.00388]], [[-0.00259, 0.0468, 0.00025, -0.02418, -0.01034, 0.0138,
        -0.02377, -0.01038, -0.01418, 0.00805, -0.0043, -0.02311, 0.00712,
        -0.01911, 0.01918, 0.03504], [0.00197, 0.00614, 0.04059, -0.01171,
        0.03042, -0.01777, 0.00573, -0.01741, -0.03757, -0.02772, -0.01655,
        0.0066, -0.00185, -0.00631, -0.00365, -0.01308], [-0.02803, 0.01194,
        0.00788, 0.00287, 0.01832, 0.0064, -0.04562, 0.02297, -0.0169,
        0.00274, 0.01103, -0.00871, -0.0054, 0.00216, -0.00216, -0.02577],
        [-0.0184, -0.02051, -0.01566, 0.00746, 0.00779, 0.01792, 0.02422,
        0.00446, 0.00041, -0.00532, 0.03457, 0.00637, -0.01655, -0.00663,
        0.00865, -0.02742]], [[-0.01541, 0.02039, 0.00185, -0.02475,
        -0.02047, -0.00376, 0.00464, -0.03519, 0.00976, 0.00933, -0.00606,
        0.00506, 0.02351, -0.02993, -0.0011, 0.01902], [0.00135, -0.01629,
        0.01549, 0.03671, 0.01935, 0.00633, 0.00205, -0.00737, -0.04381,
        -0.02456, -0.025, -0.00429, -0.01201, -0.01475, -0.0127, 0.01499],
        [-0.02649, 0.00969, -0.01514, 0.00359, 0.00476, 0.00911, -0.00838,
        0.01037, -0.03532, 0.01817, 0.03317, -0.00348, 0.02902, -0.00846,
        -0.00802, -0.01766], [0.01763, -0.01846, 0.03049, 7e-05, -0.01388,
        0.0255, 0.00281, 0.00637, 0.01874, -0.02151, 0.03117, 0.00152,
        -0.0149, 0.02933, -0.007, -0.008]], [[0.00231, 0.00498, -0.00058,
        0.00063, -0.03427, 0.00683, -0.01368, -0.00527, 0.01421, 0.03228,
        0.00048, -0.01516, -0.00301, -0.02798, 0.01618, -0.0074], [0.01033,
        0.01345, 0.01516, 0.05937, -0.00963, -0.02829, -0.00074, -0.00083,
        -0.01985, 0.01068, -0.06094, 0.00015, -0.06521, -0.00877, 0.00493,
        -0.02121], [-0.00156, 0.00645, -0.01595, -0.02207, -0.00695,
        0.00767, -0.02091, -0.00885, -0.0159, 0.03217, 0.02767, -0.01865,
        0.0157, -0.045, 0.00151, -0.01285], [-0.00634, -0.02074, -0.00406,
        -0.03036, -9e-05, 0.0003, 0.0231, -0.01864, 0.00246, -0.01277,
        -0.01305, -0.00536, -0.00295, -0.00487, -0.02521, -0.01122]]],
        "lse":
        [[12.47684, 12.4768, 12.47686, 12.47687], [12.47693, 12.47688,
        12.47686, 12.47687], [12.47689, 12.47686, 12.47686, 12.47688],
        [12.47698, 12.47685, 12.47682, 12.47694], [12.47691, 12.47689,
        12.47685, 12.47689], [12.47687, 12.47687, 12.4769, 12.47686],
        [12.47694, 12.4769, 12.47685, 12.47682], [12.4769, 12.47684,
        12.4769, 12.47692], [12.4769, 12.47688, 12.47683, 12.47689]],
        "top1":
        [[118881, 240464, 21378, 6420], [256090, 112017, 57671, 128378],
        [35138, 10379, 224192, 176543], [100482, 188357, 175014, 118764],
        [105673, 138566, 225780, 240933], [236944, 228614, 220204, 249178],
        [53334, 120412, 229778, 216747], [131663, 96489, 81406, 121744],
        [68763, 16344, 123708, 232133]],
        "margin":
        [[0.48533, 0.46193, 0.51483, 0.46438], [0.47366, 0.47233, 0.48156,
        0.48003], [0.48141, 0.4836, 0.46667, 0.4733], [0.4556, 0.4731,
        0.49632, 0.4959], [0.46397, 0.47438, 0.46986, 0.45715], [0.47175,
        0.45528, 0.47438, 0.46609], [0.48918, 0.48235, 0.50774, 0.48635],
        [0.49558, 0.45904, 0.4767, 0.48552], [0.4972, 0.4536, 0.45793,
        0.45658]],
    },
}

# serve_families_reference: each new family at full width, depth cut so
# that the JAX reference runs on a CPU (name -> arch, layers, config
# overrides): Zamba2 at one period (6 Mamba-2 layers and the shared
# block), RWKV-6 at 2 layers, DeepSeek-V2 at 2 (1 dense + 1 MoE),
# TinyLlama with the int8 KV cache at 4; hashed_params from SERVE_REF_SEED,
# serve_reference's tokens and tolerances.  The reference's logits from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py families_reference
# (jax 0.9.0, numpy 2.0.2), rounded to 5 decimals
# train_reference: TRAIN_REF_STEPS AdamW steps of the smoke TinyLlama and
# DLRM with float32 activations, numpy weights from TRAIN_REF_SEED
# (transformer_numpy_params, dlrm_numpy_params) and lm_batch / dlrm_batch
# (TRAIN_REF_BATCH: (rows, seq) or rows); each step's loss and gradient
# norm from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py train_reference
# (jax 0.9.0, numpy 2.0.2); the port on the card within rtol 1e-3
TRAIN_REF_SEED, TRAIN_REF_STEPS, TRAIN_REF_RTOL = 2, 3, 1e-3
TRAIN_REF_TCFG = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
TRAIN_REF_BATCH = {"tinyllama-1.1b": (8, 64), "dlrm": 64}
TRAIN_REF = {
    "tinyllama-1.1b": {
        "loss": [6.051462650299072, 6.013705253601074, 5.977534770965576],
        "grad_norm": [5.731514930725098, 5.182557106018066,
                      4.1219072341918945]},
    "dlrm": {
        "loss": [0.9292119741439819, 0.7119604349136353, 0.6386508941650391],
        "grad_norm": [2.0691192150115967, 1.3968948125839233,
                      1.380111813545227]},
}

FAMILIES_REF_CUTS = {
    "zamba2-1.2b": ("zamba2-1.2b", 6, {}),
    "rwkv6-3b": ("rwkv6-3b", 2, {}),
    "deepseek-v2-236b": ("deepseek-v2-236b", 2, {}),
    "tinyllama-1.1b/int8": ("tinyllama-1.1b", 4, {"kv_quant_int8": True}),
}
FAMILIES_REF = {
    'zamba2-1.2b': {
        'logits':
        [[[-1.0525399446487427, -0.3499000072479248, 0.6647199988365173,
        -0.2762399911880493, 2.904279947280884, -1.3558100461959839,
        -0.11061999946832657, 0.6677899956703186, -0.504040002822876,
        0.4353500008583069, 0.7392899990081787, 0.13872000575065613,
        0.2773999869823456, -1.9415199756622314, -0.948930025100708,
        -0.9361400008201599], [-0.4326399862766266, -0.6809300184249878,
        -0.8562999963760376, 0.6122000217437744, -0.41231000423431396,
        0.2495100051164627, 1.209130048751831, -1.026859998703003,
        1.3058700561523438, -1.1285200119018555, 0.2380100041627884,
        0.8258799910545349, 0.9433199763298035, 0.7221599817276001,
        0.005369999911636114, -0.9990699887275696], [0.3690199851989746,
        1.267699956893921, 1.1006300449371338, -0.9899100065231323,
        -0.6951799988746643, 0.31626999378204346, 0.030460000038146973,
        -0.04050999879837036, -0.29111000895500183, -1.1177799701690674,
        1.0672999620437622, -1.225849986076355, 0.5222100019454956,
        0.5580999851226807, 0.20527000725269318, 1.4510600566864014],
        [-1.3883700370788574, -1.0516200065612793, -0.43560999631881714,
        -0.6456800103187561, 0.2505199909210205, 0.6154199838638306,
        -0.3426800072193146, 0.9445599913597107, 1.105780005455017,
        0.11940000206232071, 0.3265700042247772, 0.6315900087356567,
        1.4835000038146973, 0.9933300018310547, 0.8278999924659729,
        -1.5453100204467773]], [[0.5092700123786926, -0.2954599857330322,
        0.11381000280380249, -2.761229991912842, 1.3615599870681763,
        -0.8233500123023987, -1.1386499404907227, -0.6492099761962891,
        -0.4630100131034851, -0.6165400147438049, -0.02954000048339367,
        -1.308940052986145, 0.42006000876426697, -0.14733000099658966,
        -0.25839999318122864, -0.3372200131416321], [1.9202500581741333,
        -0.9621700048446655, 1.4426300525665283, -0.1748500019311905,
        -1.6081500053405762, -0.30292001366615295, 1.5055700540542603,
        1.188480019569397, 0.8799300193786621, 0.9496899843215942,
        0.0853400006890297, 1.1876100301742554, 1.40093994140625,
        -1.6794400215148926, -0.6852499842643738, 0.8708000183105469],
        [-1.3509000539779663, 0.5873399972915649, 0.35172000527381897,
        -0.5392699837684631, -0.4662800133228302, -0.36208999156951904,
        -0.46612998843193054, 0.06293000280857086, 0.2145099937915802,
        -2.8620800971984863, 2.879539966583252, 1.6204700469970703,
        0.4064599871635437, 1.4095499515533447, -0.4168800115585327,
        -0.45563000440597534], [-2.1114399433135986, -0.4807800054550171,
        -3.2595999240875244, -1.9055700302124023, 0.19679999351501465,
        0.15410999953746796, 1.6184500455856323, -1.184190034866333,
        -1.6601099967956543, -0.47012999653816223, -0.6332200169563293,
        0.5906599760055542, 0.5473399758338928, -0.8120499849319458,
        0.12852999567985535, -1.3163199424743652]], [[0.5174800157546997,
        0.07882999628782272, 0.557420015335083, -0.8301399946212769,
        1.0654499530792236, 1.731600046157837, 1.3257299661636353,
        0.5194399952888489, -0.0868000015616417, -0.506060004234314,
        0.008840000256896019, 1.0530600547790527, 0.7285299897193909,
        -1.4901299476623535, 0.8834099769592285, -0.6735399961471558],
        [0.3569599986076355, 0.18453000485897064, -0.1534000039100647,
        -0.06576000154018402, -2.7267699241638184, -0.5918700098991394,
        1.7263799905776978, 1.2000999450683594, 0.1296900063753128,
        0.7732599973678589, -0.165460005402565, 1.8275200128555298,
        0.9909700155258179, -0.26568999886512756, 1.3004000186920166,
        -0.8690000176429749], [-0.29745998978614807, 1.139430046081543,
        1.9732400178909302, -0.9578999876976013, 0.7301999926567078,
        -0.6753900051116943, 0.1692200005054474, 1.822029948234558,
        -0.37613001465797424, -0.16200000047683716, 0.6363400220870972,
        -1.26528000831604, 0.4332500100135803, -0.3394100069999695,
        -0.04667000100016594, 0.029670000076293945], [-0.9505900144577026,
        0.1842000037431717, -0.8677499890327454, -1.2340099811553955,
        0.5562099814414978, 1.4755899906158447, 0.4867599904537201,
        0.22342999279499054, -0.06908000260591507, -0.47332999110221863,
        0.6086599826812744, 0.40615999698638916, 0.5049800276756287,
        -0.2985599935054779, -0.4398300051689148, 0.32954999804496765]],
        [[-0.8688799738883972, -0.20261000096797943, 1.587049961090088,
        -1.5727200508117676, 1.6008100509643555, 1.107159972190857,
        1.8503899574279785, 0.8643100261688232, -0.6703600287437439,
        0.7503700256347656, -0.15233999490737915, -0.9682700037956238,
        1.684749960899353, 0.006120000034570694, 0.08466999977827072,
        0.1936199963092804], [0.7314800024032593, 0.4409399926662445,
        0.09835000336170197, 0.7408999800682068, -0.4925900101661682,
        -0.3640199899673462, -0.6965600252151489, -1.0996899604797363,
        -0.43619999289512634, 0.9309999942779541, 0.653469979763031,
        -0.04673999920487404, 0.04182000085711479, -0.3352999985218048,
        1.009220004081726, -0.21071000397205353], [-1.001710057258606,
        0.1677200049161911, 0.7226999998092651, 0.20388999581336975,
        -0.8674399852752686, -1.3551000356674194, 0.5624300241470337,
        0.5435199737548828, -1.2645200490951538, -0.24145999550819397,
        -0.4508199989795685, -0.4567599892616272, 1.22871994972229,
        0.45322999358177185, 1.0702799558639526, 0.5412600040435791],
        [-1.0432100296020508, 0.11296000331640244, 0.23280000686645508,
        -1.2459399700164795, 0.7082399725914001, 1.262179970741272,
        -1.8928899765014648, -0.402539998292923, -0.27619999647140503,
        0.5986199975013733, -0.010850000195205212, 0.24726000428199768,
        -0.3223400115966797, -0.3993000090122223, 0.8862699866294861,
        0.5021399855613708]], [[0.34303000569343567, 0.2995400130748749,
        1.5762100219726562, -0.14781999588012695, -0.9569799900054932,
        -0.6740000247955322, -0.1930299997329712, 0.20446999371051788,
        0.9072399735450745, 0.33744001388549805, 1.193429946899414,
        0.052069999277591705, 0.2722199857234955, 0.855459988117218,
        0.21174000203609467, 1.5676300525665283], [-1.0069199800491333,
        1.050819993019104, -0.8044599890708923, -0.07515999674797058,
        0.12525999546051025, 0.4327000081539154, -1.0629299879074097,
        -1.1803300380706787, 0.8811399936676025, -0.02046000026166439,
        0.45013999938964844, -0.45482999086380005, -0.026149999350309372,
        -0.9656299948692322, 0.0025100000202655792, -0.7950199842453003],
        [-1.111199975013733, 0.6968100070953369, 0.3521699905395508,
        -1.8437700271606445, 0.7257500290870667, 0.35475999116897583,
        -1.134119987487793, -0.8492500185966492, -0.44095999002456665,
        0.09662000089883804, 0.41418999433517456, -0.7484400272369385,
        -2.063999891281128, -0.19158999621868134, 1.4016799926757812,
        0.8550999760627747], [-1.0325900316238403, -0.43334001302719116,
        -0.25519001483917236, -0.7143700122833252, 0.3552899956703186,
        0.8075000047683716, -0.14585000276565552, -0.6623499989509583,
        1.0648000240325928, 1.0127899646759033, 0.7663400173187256,
        0.2197200059890747, -0.3517700135707855, -0.5032299757003784,
        1.8188600540161133, -0.8969799876213074]], [[0.6312199831008911,
        1.0227299928665161, 1.1103299856185913, -1.3507699966430664,
        0.17497999966144562, -1.0593700408935547, 0.006479999981820583,
        0.4280399978160858, -1.6202900409698486, 0.2596000134944916,
        -0.8261299729347229, -1.279960036277771, 0.4409799873828888,
        0.45399001240730286, 1.0517499446868896, 0.02370000071823597],
        [-0.8835899829864502, 0.445389986038208, -0.785290002822876,
        -1.7592600584030151, 0.4980500042438507, -0.2156900018453598,
        -0.008740000426769257, 0.4902600049972534, -0.6512399911880493,
        0.12691999971866608, 2.5129599571228027, 1.2516800165176392,
        0.5002300143241882, -0.5691099762916565, -0.44933000206947327,
        0.28439000248908997], [0.0658000037074089, 0.8968999981880188,
        0.49153000116348267, 0.09711000323295593, -0.7480199933052063,
        0.5288000106811523, 0.25450000166893005, 0.8595399856567383,
        1.6586400270462036, -0.5532799959182739, -0.9251700043678284,
        -0.16808000206947327, -0.3223699927330017, -0.30566999316215515,
        0.9670100212097168, 0.516260027885437], [0.6169800162315369,
        0.0850600004196167, 0.07264000177383423, -1.0830199718475342,
        0.03822999820113182, 2.783829927444458, -0.7399799823760986,
        -0.8648200035095215, 0.9927700161933899, 1.720020055770874,
        0.5115699768066406, -1.4132599830627441, -0.7431600093841553,
        -0.5013899803161621, -0.47067001461982727, -0.35931000113487244]],
        [[0.3666200041770935, -0.6057999730110168, 0.05621999874711037,
        -1.243399977684021, 0.11321999877691269, -0.11298999935388565,
        0.8063700199127197, 0.754830002784729, -0.7268199920654297,
        0.6860700249671936, 0.7971400022506714, -1.3918499946594238,
        -1.37431001663208, -2.3819499015808105, 0.08833999931812286,
        -0.22033999860286713], [-0.9339500069618225, 0.21705999970436096,
        0.562030017375946, -0.7990099787712097, 0.21994000673294067,
        0.19110000133514404, -0.14122000336647034, -1.5339499711990356,
        0.4464299976825714, 0.06640999764204025, 0.10147999972105026,
        -0.5054799914360046, 1.9276100397109985, -1.4880199432373047,
        0.16227999329566956, -0.5304399728775024], [-0.7280099987983704,
        0.3033199906349182, 0.21150000393390656, -0.34213998913764954,
        0.24271999299526215, -1.6425000429153442, -2.2797698974609375,
        0.2917500138282776, 0.15339000523090363, -1.0492299795150757,
        -0.6119099855422974, -1.2906800508499146, -0.44231998920440674,
        0.17861999571323395, 0.3230699896812439, 0.5316600203514099],
        [-0.13544000685214996, 0.5801100134849548, 0.2611599862575531,
        -1.0903600454330444, 0.8994500041007996, 0.15771999955177307,
        -1.1448099613189697, -1.5424000024795532, -0.013609999790787697,
        -1.1005300283432007, 0.3612099885940552, -0.6413300037384033,
        0.7308200001716614, -0.32003000378608704, 0.34630998969078064,
        0.4454199969768524]], [[-0.31808000802993774, 0.2318599969148636,
        0.06029000133275986, 0.29659000039100647, -0.06350000202655792,
        1.0065799951553345, 0.3789600133895874, -0.0776899978518486,
        -0.934149980545044, -0.781440019607544, -0.5623499751091003,
        0.8685299754142761, -1.1421400308609009, 0.9332699775695801,
        0.9144600033760071, -0.9487400054931641], [0.11751999706029892,
        1.176900029182434, 0.7919700145721436, -1.3935500383377075,
        -0.7264999747276306, 1.986840009689331, 1.2442899942398071,
        -0.5654199719429016, 0.35040000081062317, -0.16087999939918518,
        1.6016700267791748, -0.7120599746704102, 2.2001800537109375,
        -0.9365299940109253, -0.6263300180435181, -0.814079999923706],
        [-1.381790041923523, 0.6023799777030945, 1.58187997341156,
        1.6348899602890015, 0.7791699767112732, -0.4537000060081482,
        0.07797999680042267, 0.5284799933433533, 1.344920039176941,
        -0.0014199999859556556, -1.3189899921417236, 0.24291999638080597,
        0.5287700295448303, 1.0092400312423706, 0.8203999996185303,
        -0.37268000841140747], [-0.5958600044250488, -0.7834200263023376,
        0.5906800031661987, 1.7240300178527832, -1.1492899656295776,
        0.14143000543117523, 1.6568299531936646, -0.8954600095748901,
        1.7635200023651123, -0.5047900080680847, 1.04489004611969,
        1.1656099557876587, 2.0297698974609375, -0.9094399809837341,
        0.7649499773979187, -0.9704800248146057]], [[0.2905699908733368,
        -1.7065199613571167, -0.3942599892616272, -0.8359599709510803,
        -0.0088900001719594, -0.04465999826788902, -0.9959700107574463,
        0.05796999856829643, 0.5555999875068665, -0.5952200293540955,
        -1.6219899654388428, -1.3810900449752808, -0.5854799747467041,
        1.197849988937378, 1.2369099855422974, -0.4309700131416321],
        [-0.13217000663280487, 0.2270199954509735, -0.3757599890232086,
        -0.9715700149536133, -1.7598700523376465, -0.8945800065994263,
        1.1247899532318115, 0.08437000215053558, 0.6687899827957153,
        0.03759000077843666, 0.07582999765872955, 1.8532500267028809,
        0.9196900129318237, 0.3276199996471405, 1.0116100311279297,
        0.7381799817085266], [-1.0433399677276611, 1.639009952545166,
        1.0745099782943726, -0.8119000196456909, -0.34797999262809753,
        -1.1805000305175781, -1.1866600513458252, 0.30546998977661133,
        0.21509000658988953, 0.5291299819946289, 0.5810800194740295,
        0.661270022392273, -0.10696999728679657, 1.9673099517822266,
        -0.022789999842643738, -0.22532999515533447], [0.5903900265693665,
        0.399399995803833, 0.5669400095939636, -0.038509998470544815,
        -0.915149986743927, 1.039080023765564, -0.7000899910926819,
        0.6421200037002563, -0.312389999628067, -0.15851999819278717,
        0.7705600261688232, -0.5159199833869934, 0.2624399960041046,
        0.8504899740219116, 1.4601000547409058, 2.008270025253296]]],
        'lse':
        [[10.78113, 10.79196, 10.78546, 10.77616], [10.77312, 10.78811,
        10.78513, 10.78732], [10.79004, 10.78631, 10.79107, 10.77806],
        [10.78309, 10.79865, 10.78503, 10.78957], [10.77828, 10.7948,
        10.79228, 10.79156], [10.79124, 10.79845, 10.78461, 10.78315],
        [10.78009, 10.79128, 10.7808, 10.78281], [10.79472, 10.78617,
        10.78643, 10.77432], [10.79156, 10.77864, 10.77368, 10.79066]],
        'top1':
        [[23365, 12324, 29620, 25117], [12229, 8078, 24684, 19078], [19461,
        608, 29028, 19781], [14486, 24332, 27336, 26875], [12411, 10182,
        15459, 331], [28981, 17852, 9614, 16340], [6099, 23192, 21057, 29115],
        [8422, 14724, 11157, 10467], [29868, 23069, 20211, 7350]],
        'margin':
        [[0.096, 0.15073, 0.6974, 0.38399], [0.08438, 0.26927, 0.08756,
        0.21302], [0.33312, 0.33711, 0.16612, 0.4273], [0.10109, 0.33893,
        0.614, 0.47655], [0.05305, 0.21541, 0.26047, 0.00525], [0.5646,
        0.05448, 0.09321, 0.00636], [0.09831, 0.03691, 0.21887, 0.15957],
        [0.43211, 0.56014, 0.27945, 0.16468], [0.45005, 0.02783, 0.0621,
        0.1146]],
    },
    'rwkv6-3b': {
        'logits':
        [[[-2.58351993560791, -0.2697699964046478, 0.8372799754142761,
        0.27360999584198, 1.3703299760818481, -0.4918400049209595,
        0.13300000131130219, 2.0053999423980713, 0.6164500117301941,
        0.49011000990867615, -0.7581599950790405, 0.0700099989771843,
        -1.183590054512024, 0.3664500117301941, 0.3037799894809723,
        -0.017030000686645508], [0.21121999621391296, -0.5378999710083008,
        0.7249900102615356, 1.3630499839782715, 0.5893300175666809,
        -0.18556000292301178, 1.5708099603652954, -0.43334999680519104,
        0.4854300022125244, 0.11110000312328339, 0.23917999863624573,
        -0.07021000236272812, -1.034850001335144, -0.02841999940574169,
        -1.1985000371932983, 1.0253499746322632], [0.7031199932098389,
        -0.07513000071048737, 1.0067399740219116, 0.0640299990773201,
        0.5703999996185303, -0.742579996585846, 0.8605499863624573,
        -0.46303999423980713, 0.283160001039505, 0.33522000908851624,
        -2.2180800437927246, 0.5855500102043152, 0.46851998567581177,
        0.7432299852371216, -0.27046000957489014, 0.130280002951622],
        [0.030880000442266464, 0.31782999634742737, 1.5438200235366821,
        0.27601000666618347, 0.3507699966430664, -0.1688700020313263,
        -0.07591000199317932, 1.0973700284957886, 0.19157999753952026,
        0.5511000156402588, -1.6231800317764282, -0.7573099732398987,
        -1.137179970741272, 0.6216599941253662, 0.38905999064445496,
        -2.2154200077056885]], [[-2.286370038986206, 1.5791399478912354,
        0.4877200126647949, -0.9352800250053406, 0.7864300012588501,
        -1.617709994316101, 0.4274199903011322, -0.3676300048828125,
        0.5824999809265137, 1.1790200471878052, 0.8931300044059753,
        1.9665100574493408, 0.12224999815225601, 0.05724000185728073,
        0.012310000136494637, -0.574940025806427], [-1.7202099561691284,
        -0.8484100103378296, 0.7121700048446655, -0.42607998847961426,
        1.7266900539398193, -2.434540033340454, -0.5164899826049805,
        -1.3247699737548828, -1.0285199880599976, 0.2894099950790405,
        1.4200999736785889, 0.4778499901294708, 0.7876600027084351,
        0.13478000462055206, -0.18528999388217926, -1.154270052909851],
        [-1.276129961013794, 0.3743799924850464, -1.7874300479888916,
        1.2127200365066528, 0.3479900062084198, 0.4186500012874603,
        -0.6320300102233887, 2.483750104904175, -0.4694400131702423,
        -1.8618299961090088, -0.4585300087928772, -0.16549000144004822,
        -0.025289999321103096, -0.6707800030708313, -0.5203800201416016,
        -1.4640400409698486], [-0.8461700081825256, 0.34483999013900757,
        0.6518499851226807, 0.6292600035667419, 0.48899000883102417,
        -0.3344700038433075, 0.11692000180482864, -0.04513999819755554,
        -0.9484599828720093, 1.3575600385665894, 1.0370800495147705,
        0.5604599714279175, -0.737030029296875, 0.5179600119590759,
        0.09446000307798386, -0.3660300076007843]], [[-2.6856000423431396,
        -1.478410005569458, 1.4796700477600098, 0.39765000343322754,
        0.38530001044273376, 0.17778000235557556, -0.8812599778175354,
        -0.48420000076293945, -0.1884399950504303, 0.1433500051498413,
        -1.0950100421905518, -0.2829500138759613, 0.42294999957084656,
        -0.7559900283813477, 1.6309700012207031, 0.5245699882507324],
        [-1.2820899486541748, -0.3840799927711487, 0.8403400182723999,
        1.150730013847351, 1.2746299505233765, -1.7336499691009521,
        -1.2603399753570557, 1.2982900142669678, 1.3219300508499146,
        -0.8667799830436707, -0.2329999953508377, -0.9845499992370605,
        1.086150050163269, 0.32721999287605286, -0.3519099950790405,
        -0.9065799713134766], [0.30338001251220703, 0.3957900106906891,
        0.9500399827957153, -0.45311999320983887, 1.3945399522781372,
        -0.8364499807357788, -0.3469899892807007, 0.9537799954414368,
        0.69718998670578, -0.5223699808120728, 1.0989099740982056,
        0.25817999243736267, 0.8596500158309937, -0.411080002784729,
        -0.6134300231933594, -0.2904599905014038], [-1.2099699974060059,
        -1.2872799634933472, -0.6661499738693237, 0.5506600141525269,
        1.8006800413131714, -0.05758000165224075, 0.29335999488830566,
        0.6022800207138062, 0.6255599856376648, 1.0684599876403809,
        0.29291000962257385, -0.039820000529289246, 0.3540000021457672,
        0.19469000399112701, -3.0774500370025635, -2.4945099353790283]],
        [[-1.0963000059127808, -2.2317800521850586, 2.1294500827789307,
        1.334879994392395, 1.543370008468628, 0.7574499845504761,
        -0.29805999994277954, 0.6968899965286255, -0.18735000491142273,
        -1.2559700012207031, 0.667900025844574, -1.3973900079727173,
        0.9010499715805054, 1.4449100494384766, -0.5267400145530701,
        0.09275999665260315], [-0.6473900079727173, -0.01899000070989132,
        -0.4666599929332733, -0.5959799885749817, 0.6360200047492981,
        -1.3020399808883667, 0.050700001418590546, -0.08229000121355057,
        0.1314300000667572, -2.474289894104004, 0.504580020904541,
        -0.31633999943733215, 1.3043299913406372, -0.23465000092983246,
        -0.5678799748420715, -0.17079000174999237], [-2.2751801013946533,
        0.8521999716758728, 1.3562099933624268, -0.38969001173973083,
        0.6688699722290039, 0.37512001395225525, -0.29857999086380005,
        2.0305099487304688, -1.1943999528884888, 1.8244400024414062,
        -1.2534699440002441, 0.6920199990272522, 0.18182000517845154,
        0.640529990196228, 1.9750200510025024, 0.2415499985218048],
        [-0.4160600006580353, -1.44336998462677, -0.6785299777984619,
        -0.12391000241041183, 1.394610047340393, -0.6560500264167786,
        -0.3512899875640869, -0.17794999480247498, 1.0675899982452393,
        0.6270300149917603, 0.07246000319719315, 0.7059800028800964,
        0.5021200180053711, 0.5788800120353699, 0.5508000254631042,
        -1.7190300226211548]], [[-1.0305099487304688, -0.8791599869728088,
        -0.33893999457359314, -0.5309799909591675, 0.8454300165176392,
        0.8451700210571289, -0.4114600121974945, 0.3605000078678131,
        -0.463019996881485, -0.04831999912858009, -1.4799799919128418,
        -0.8001199960708618, 0.07569000124931335, -0.23892000317573547,
        -0.6324999928474426, -0.5630199909210205], [-2.4030098915100098,
        -1.447890043258667, 0.6297299861907959, 0.00977999996393919,
        0.7617800235748291, 0.40573999285697937, -1.9155700206756592,
        0.9466300010681152, -0.3818199932575226, 0.7019299864768982,
        -1.3538299798965454, 0.23916999995708466, 0.1712300032377243,
        0.7976999878883362, -0.8163700103759766, -0.3056800067424774],
        [-0.5424200296401978, 0.7781999707221985, 0.3689799904823303,
        -0.27368998527526855, -0.5851600170135498, -0.7334200143814087,
        0.20426000654697418, 0.620639979839325, 0.23939000070095062,
        0.050280001014471054, 0.6341500282287598, 1.2487900257110596,
        -1.1845899820327759, 0.8705000281333923, 1.5072300434112549,
        -0.22236000001430511], [-1.5466899871826172, -0.5301200151443481,
        -0.17326000332832336, -0.42489001154899597, 1.5184799432754517,
        -0.2608200013637543, -0.28624001145362854, 1.610450029373169,
        1.2339600324630737, 0.41640999913215637, -0.6476600170135498,
        -0.8156200051307678, 1.308150053024292, -2.7723801136016846,
        -0.7558500170707703, 0.5028799772262573]], [[-0.5868099927902222,
        1.5570299625396729, 1.5013099908828735, -0.12932999432086945,
        -0.19425000250339508, -1.5275599956512451, -1.2581499814987183,
        1.2918599843978882, 0.48256999254226685, -0.7368199825286865,
        1.434059977531433, 0.2861799895763397, -0.24007999897003174,
        1.9586199522018433, -0.4184499979019165, 0.0020200000144541264],
        [-1.3420100212097168, 0.6758999824523926, 0.1246500015258789,
        -1.0898699760437012, 0.9258700013160706, -1.4056600332260132,
        0.6352300047874451, -0.5420799851417542, -0.2249699980020523,
        0.22642000019550323, -0.3749699890613556, -0.28621000051498413,
        0.9502800107002258, 0.5251299738883972, 0.9111499786376953,
        -0.6294999718666077], [0.929610013961792, -1.897070050239563,
        -0.23277999460697174, 0.17881999909877777, -0.4499100148677826,
        -0.7481899857521057, 0.046799998730421066, 1.1251499652862549,
        0.3404200077056885, -1.11381995677948, 0.02449999935925007,
        -0.861549973487854, 0.8992800116539001, 0.21786999702453613,
        1.3876899480819702, -0.7693300247192383], [-2.284600019454956,
        -0.3958899974822998, -0.3152500092983246, -0.6631799936294556,
        0.9533200263977051, -0.3144499957561493, -0.383109986782074,
        0.18799999356269836, -0.49467000365257263, 0.6498200297355652,
        -0.5613999962806702, 0.20051999390125275, -0.3022400140762329,
        0.8901100158691406, 0.1629599928855896, -2.135499954223633]],
        [[-1.6250100135803223, -1.003100037574768, -0.8448200225830078,
        0.7110599875450134, 1.2272299528121948, -1.8849400281906128,
        -0.3224799931049347, 0.10232000052928925, -0.16378000378608704,
        0.5581499934196472, 2.313199996948242, 0.5683299899101257,
        -0.46401000022888184, -0.40922001004219055, -1.4256000518798828,
        -1.5565799474716187], [-1.2051299810409546, 0.9808599948883057,
        -1.6288399696350098, 0.17517000436782837, 0.7176799774169922,
        0.9811199903488159, -0.152879998087883, -1.7285100221633911,
        -0.870140016078949, -0.0019600000232458115, 0.48454999923706055,
        -0.5753200054168701, 0.4395900070667267, -0.07096000015735626,
        -1.03125, 0.08816000074148178], [-0.6797000169754028,
        -0.3583199977874756, 0.5093600153923035, -0.5856500267982483,
        0.8355799913406372, -0.7315199971199036, -1.0709999799728394,
        1.006909966468811, -0.5748599767684937, 1.5187900066375732,
        -0.07071000337600708, -0.6650199890136719, 0.9347599744796753,
        0.6242899894714355, -0.2542699873447418, 0.677370011806488],
        [-1.5717699527740479, 1.0986100435256958, -0.05545999854803085,
        -0.3650299906730652, 1.303570032119751, 1.5216399431228638,
        0.2158699929714203, 1.4086300134658813, 0.06519000232219696,
        -0.20263999700546265, -1.4265199899673462, -0.8369399905204773,
        -1.5467599630355835, -0.7178800106048584, 1.186650037765503,
        -0.4805000126361847]], [[-1.6388299465179443, 1.2687499523162842,
        -0.18379999697208405, -1.0471199750900269, 0.6469200253486633,
        -1.9903099536895752, -0.11071000248193741, 0.5160499811172485,
        -0.2421099990606308, 0.06819000095129013, -1.211650013923645,
        -1.9752600193023682, 0.046939998865127563, 1.2680599689483643,
        -0.010379999876022339, -0.5620999932289124], [-0.17608000338077545,
        0.42054998874664307, 0.2485000044107437, 0.33333998918533325,
        -0.26361000537872314, -0.5515999794006348, 0.6785299777984619,
        0.38468998670578003, 0.08613000065088272, 0.1668200045824051,
        0.4870299994945526, -1.174430012702942, 0.0023499999660998583,
        -0.3439500033855438, 0.8287000060081482, -0.9936100244522095],
        [-0.4848099946975708, -1.1612999439239502, 1.1134400367736816,
        0.5950800180435181, 2.2902801036834717, -1.0797699689865112,
        -0.324180006980896, 0.3925899863243103, 0.05496999993920326,
        0.07744999974966049, 0.3103800117969513, -0.1475600004196167,
        0.6811100244522095, -0.47064000368118286, -0.23475000262260437,
        -0.5173199772834778], [-0.8242200016975403, -0.1481499969959259,
        1.1839499473571777, -0.8524600267410278, 0.618149995803833,
        -1.429110050201416, 0.34097999334335327, 0.5013800263404846,
        1.4490100145339966, 0.15298999845981598, 1.1947200298309326,
        -0.1151600033044815, -0.14926999807357788, 1.1179399490356445,
        -0.9335200190544128, -1.3295899629592896]], [[0.5351799726486206,
        -0.8350899815559387, 0.2083600014448166, -1.6145999431610107,
        2.7353200912475586, -0.1723400056362152, 0.9285699725151062,
        0.5654299855232239, 1.4996399879455566, -1.1397500038146973,
        0.7768300175666809, -1.1665500402450562, 1.6139299869537354,
        -0.20494000613689423, -0.026890000328421593, 0.750980019569397],
        [-0.18705999851226807, -1.1245100498199463, 1.0485399961471558,
        0.8416200280189514, 0.8565499782562256, -0.8881700038909912,
        -0.30663999915122986, 1.0842399597167969, 0.7439500093460083,
        -1.0696799755096436, -1.7601300477981567, -1.7258000373840332,
        0.2909800112247467, 0.630079984664917, -0.12110000103712082,
        -1.6450799703598022], [-1.1421300172805786, -1.3494399785995483,
        0.7025700211524963, 0.5037099719047546, 1.9206199645996094,
        -1.5682599544525146, -0.4232200086116791, 0.4641999900341034,
        1.1159499883651733, -0.9197999835014343, -1.1769800186157227,
        0.4039199948310852, 0.32659998536109924, 1.0937000513076782,
        0.014050000347197056, 0.07947000116109848], [0.559939980506897,
        0.36713001132011414, 0.60698002576828, 1.3564300537109375,
        -0.12205000221729279, 0.11631999909877777, 1.1333099603652954,
        -0.29559001326560974, 0.18874000012874603, -0.06624999642372131,
        0.9549000263214111, -0.9704800248146057, -0.055720001459121704,
        0.48598000407218933, 0.11699999868869781, -0.7973499894142151]]],
        'lse':
        [[11.58845, 11.58916, 11.58949, 11.59227], [11.59275, 11.58927,
        11.59784, 11.58001], [11.58511, 11.58527, 11.58873, 11.59606],
        [11.58819, 11.58878, 11.59957, 11.59343], [11.60213, 11.59815,
        11.5929, 11.58767], [11.59672, 11.58982, 11.59153, 11.59243],
        [11.59872, 11.59273, 11.60591, 11.59092], [11.59437, 11.58225,
        11.59837, 11.60368], [11.58804, 11.5949, 11.5949, 11.5867]],
        'top1':
        [[57899, 11286, 45845, 54866], [16760, 6535, 43012, 50557], [10361,
        6240, 14990, 47242], [392, 45257, 34957, 27237], [11286, 17455, 51992,
        18169], [41145, 64481, 17273, 10943], [6411, 7240, 61241, 21087],
        [58143, 53153, 62892, 62428], [60479, 50641, 15076, 22808]],
        'margin':
        [[0.98951, 0.16182, 0.40884, 0.06956], [0.26097, 0.46731, 0.06816,
        0.03451], [0.07464, 0.10975, 0.51938, 0.62356], [0.10911, 0.0545,
        0.03354, 0.84935], [0.90578, 0.07006, 0.08554, 0.16433], [0.52451,
        0.08282, 0.03427, 0.06014], [0.13598, 0.05342, 0.02037, 0.38934],
        [0.75013, 0.04285, 0.15151, 0.0938], [0.0196, 0.2626, 0.04127,
        0.25642]],
    },
    'tinyllama-1.1b/int8': {
        'logits':
        [[[-1.0214699506759644, -2.0589499473571777, 0.24397000670433044,
        -0.16726000607013702, -1.9931000471115112, -0.4408699870109558,
        1.0226999521255493, -0.38464000821113586, 1.2352399826049805,
        -0.2720299959182739, 1.3593599796295166, -0.2332099974155426,
        0.9956700205802917, -2.256469964981079, 0.3215399980545044,
        -0.2921200096607208], [-0.09470000118017197, -0.05854000151157379,
        0.5296199917793274, 0.8910099864006042, 0.5604699850082397,
        -1.662619948387146, -0.43202999234199524, 0.9211400151252747,
        -1.593500018119812, 1.4216200113296509, -1.9921300411224365,
        -1.0391099452972412, 0.43999001383781433, 0.27978000044822693,
        0.6431000232696533, 0.8213899731636047], [-1.4402400255203247,
        0.01720000058412552, 0.7592399716377258, 0.6949099898338318,
        -0.6931399703025818, -0.7961599826812744, 0.1897599995136261,
        -0.8807299733161926, -0.2394700050354004, 0.21061000227928162,
        0.7608500123023987, -1.5503300428390503, 1.8705400228500366,
        0.21156999468803406, -1.2370100021362305, -0.7538099884986877],
        [0.9122700095176697, 0.8688099980354309, 1.4751900434494019,
        1.6810599565505981, 0.21038000285625458, 0.2552199959754944,
        1.992840051651001, 1.3516299724578857, -0.689050018787384,
        1.1809600591659546, -0.43762001395225525, -2.3530900478363037,
        -0.07720000296831131, 0.45702001452445984, 0.49340999126434326,
        -1.2730300426483154]], [[-0.16103999316692352, -2.873460054397583,
        -0.4264400005340576, 0.4410099983215332, -0.6635000109672546,
        0.47126999497413635, 0.40895000100135803, -0.3657900094985962,
        0.8957800269126892, -0.09702000021934509, 0.9105299711227417,
        -0.9212999939918518, -0.15177999436855316, -0.6062399744987488,
        0.008709999732673168, 1.4417799711227417], [0.6189500093460083,
        0.4934900104999542, -0.26061001420021057, -1.305799961090088,
        0.08794999867677689, -0.625760018825531, -0.7452700138092041,
        0.47317999601364136, -1.6336499452590942, -0.07643000036478043,
        -1.3746000528335571, -0.7805100083351135, 0.0764399990439415,
        -1.041890025138855, 1.2359000444412231, 1.6307599544525146],
        [-1.9540499448776245, 0.7807999849319458, 0.262580007314682,
        -0.7322099804878235, -0.24149000644683838, -1.2330000400543213,
        0.338809996843338, -1.3819999694824219, -2.3364899158477783,
        -0.00892999954521656, 0.8441799879074097, -1.5519200563430786,
        -0.05285999923944473, -0.09914000332355499, -1.318060040473938,
        -1.514780044555664], [-1.1728299856185913, 0.48750999569892883,
        0.17082999646663666, 2.315119981765747, -0.336760014295578,
        0.4646399915218353, -0.15022000670433044, 1.8247499465942383,
        -0.005940000060945749, 0.6305000185966492, -1.1649999618530273,
        -2.0939199924468994, -0.7984499931335449, 0.7175400257110596,
        0.06759999692440033, -0.5596299767494202]], [[0.822920024394989,
        -1.491819977760315, 0.653659999370575, 1.2870399951934814,
        -0.373089998960495, 0.11881999671459198, 1.5491600036621094,
        0.5169500112533569, -1.2916200160980225, -1.2213200330734253,
        0.8040000200271606, -0.39812999963760376, -0.8341299891471863,
        -1.1140600442886353, -0.014619999565184116, -0.22405000030994415],
        [-0.2932400107383728, -0.6775199770927429, 0.12836000323295593,
        0.4699299931526184, 1.2096799612045288, -0.901170015335083,
        0.11375000327825546, 1.2422900199890137, -1.7814300060272217,
        -0.1459999978542328, -0.8330600261688232, -0.9878699779510498,
        -0.1741500049829483, 1.1509300470352173, 1.1593400239944458,
        0.2646400034427643], [-0.6577399969100952, 0.29451000690460205,
        -0.7283999919891357, -0.9239699840545654, -0.6660199761390686,
        0.10723000019788742, 0.35554999113082886, -0.7681900262832642,
        -2.3387200832366943, 0.09329000115394592, 0.4755200147628784,
        0.15488000214099884, 0.8618900179862976, 0.9148100018501282,
        -1.6153099536895752, -1.1951899528503418], [-0.5835999846458435,
        0.7178199887275696, 0.5068299770355225, 2.2751901149749756,
        -0.7717999815940857, 0.08042000234127045, 1.791450023651123,
        1.6456600427627563, 0.014469999819993973, 1.4613100290298462,
        -0.39739999175071716, -1.2383899688720703, -1.3691099882125854,
        0.5442000031471252, 1.0620800256729126, -1.4834599494934082]],
        [[-0.1715099960565567, -1.5785499811172485, 0.7818099856376648,
        -0.01916000060737133, 0.43345001339912415, 1.3809200525283813,
        0.9134500026702881, 0.4379499852657318, 1.334130048751831,
        0.2569600045681, -0.2879500091075897, -1.3555599451065063,
        0.20284000039100647, -0.6302199959754944, 0.9530900120735168,
        0.9700400233268738], [0.17971999943256378, 0.6101999878883362,
        1.0513999462127686, 0.0963200032711029, 0.9302099943161011,
        -0.23940999805927277, -0.8767399787902832, 1.3978099822998047,
        -1.544950008392334, 1.400339961051941, -0.61735999584198,
        0.19472000002861023, -0.051500000059604645, 0.15855999290943146,
        0.5734400153160095, 0.5597500205039978], [-1.9323999881744385,
        0.3773699998855591, 0.5033800005912781, 1.141010046005249,
        0.4706999957561493, -0.10152000188827515, 0.6263800263404846,
        0.0700099989771843, -0.3443399965763092, 1.6690000295639038,
        1.0858299732208252, -0.17241999506950378, 1.3758599758148193,
        0.8036800026893616, -1.668179988861084, -1.8817600011825562],
        [-0.7722100019454956, 1.13264000415802, -0.20931999385356903,
        0.9792400002479553, 0.3135699927806854, 0.9737300276756287,
        1.1010700464248657, 1.4529600143432617, -0.5558099746704102,
        0.7136300206184387, 0.06159999966621399, -1.785730004310608,
        -0.8295400142669678, 1.3349000215530396, 1.6167000532150269,
        -1.7992700338363647]], [[1.321120023727417, -1.8167599439620972,
        -0.054349999874830246, -0.08795999735593796, 0.06531000137329102,
        1.2360999584197998, 0.4196699857711792, -0.7951899766921997,
        1.063040018081665, -1.284440040588379, 0.7049599885940552,
        0.8412600159645081, 0.2397100031375885, -1.8553600311279297,
        0.8074300289154053, 1.0981500148773193], [0.7742800116539001,
        0.48910999298095703, 0.4807400107383728, 0.2610799968242645,
        -0.19160999357700348, -0.12825000286102295, -1.1599199771881104,
        1.5437300205230713, -2.6361799240112305, -0.39566001296043396,
        -1.2392799854278564, 0.16845999658107758, 0.9135100245475769,
        -1.1449400186538696, -0.09943000227212906, 1.6989500522613525],
        [-0.22479000687599182, 0.08504000306129456, 0.10998000204563141,
        1.2863399982452393, -0.1297599971294403, -0.6305999755859375,
        0.5876700282096863, -1.5831400156021118, -0.20052999258041382,
        0.8934999704360962, 1.3002599477767944, -1.0375299453735352,
        0.952269971370697, 1.1233799457550049, -0.5681599974632263,
        -1.5566699504852295], [-1.1579899787902832, -0.21957999467849731,
        -0.6193600296974182, 1.9904500246047974, -0.9571899771690369,
        1.3269699811935425, 0.4110400080680847, 0.49393001198768616,
        1.0010499954223633, 0.8552299737930298, -0.7496399879455566,
        -1.6922099590301514, -0.8785099983215332, 0.8829600214958191,
        0.9476799964904785, -2.572279930114746]], [[0.9612100124359131,
        -2.0014400482177734, -0.6511600017547607, -0.5599899888038635,
        0.11483000218868256, -0.4626699984073639, 1.4064500331878662,
        0.7165799736976624, 0.9753000140190125, -0.34950000047683716,
        0.6309099793434143, -0.9235600233078003, -0.5462700128555298,
        -0.6067799925804138, 0.507669985294342, 0.6432999968528748],
        [0.8668400049209595, 0.14295999705791473, 0.3395499885082245,
        0.13997000455856323, -0.5833899974822998, 0.07591000199317932,
        -0.5777199864387512, -0.4427500069141388, -1.998420000076294,
        0.2627499997615814, -1.2514899969100952, 0.6157699823379517,
        0.3578200042247772, 0.4803299903869629, -0.07989999651908875,
        0.06419000029563904], [-0.7351400256156921, -0.6245499849319458,
        1.4574099779129028, 0.46634000539779663, -1.3317099809646606,
        0.20723000168800354, 0.5119199752807617, -2.2923901081085205,
        -1.6805399656295776, 0.2595199942588806, 1.2338500022888184,
        -0.6604200005531311, 0.9136499762535095, 0.08006999641656876,
        -1.2006399631500244, -1.3127800226211548], [-0.6676999926567078,
        0.33698999881744385, -1.659409999847412, 0.8252599835395813,
        0.520799994468689, 1.1604499816894531, -0.6920199990272522,
        0.2569600045681, -0.49483999609947205, -0.1886799931526184,
        -1.2195199728012085, -1.0746599435806274, 0.21235999464988708,
        0.4394800066947937, 0.7404099702835083, -1.585170030593872]],
        [[1.0250799655914307, -2.832360029220581, 0.06936000287532806,
        1.1046899557113647, -1.077370047569275, 0.41690000891685486,
        0.7959399819374084, -0.9646599888801575, 1.7605500221252441,
        -0.24110999703407288, -0.3756900131702423, -0.08848000317811966,
        -0.4397900104522705, -0.371969997882843, 0.11016999930143356,
        1.6151200532913208], [-1.0316400527954102, 0.26759999990463257,
        -0.42778998613357544, 0.01027000043541193, -1.0806100368499756,
        -0.39934998750686646, -0.6916800141334534, -0.2616100013256073,
        -2.2708001136779785, 0.46101999282836914, -1.3636800050735474,
        -1.306820034980774, 0.5103700160980225, -0.6944699883460999,
        1.1484299898147583, 1.1571500301361084], [-0.7652000188827515,
        0.4589200019836426, -1.468809962272644, 0.5317599773406982,
        -0.012129999697208405, -0.5821700096130371, 1.0074599981307983,
        -1.8421200513839722, -0.8621600270271301, 0.13399000465869904,
        0.3608799874782562, -0.7675399780273438, 1.3035900592803955,
        -0.31762000918388367, -0.9512199759483337, -1.318160057067871],
        [-1.8979599475860596, 0.5802500247955322, -0.2503400146961212,
        1.3275400400161743, -1.0202499628067017, 1.0981999635696411,
        1.5920699834823608, 0.3898800015449524, 0.08291999995708466,
        0.6244900226593018, 0.01761000044643879, -1.50941002368927,
        -0.8275099992752075, 0.99235999584198, 1.6202600002288818,
        -0.714460015296936]], [[0.42392000555992126, -1.5553200244903564,
        -0.4138700067996979, 1.0700500011444092, -0.4253399968147278,
        0.7030199766159058, 0.9330000281333923, -0.10760000348091125,
        0.30410999059677124, -0.06177999824285507, 0.4994800090789795,
        0.9291999936103821, -0.44460999965667725, -2.277750015258789,
        -0.09573999792337418, 1.5151699781417847], [0.37762999534606934,
        1.7828500270843506, 1.0575100183486938, 1.450350046157837,
        -0.056129999458789825, -0.9200599789619446, -0.7251999974250793,
        1.5745699405670166, -2.0137200355529785, 0.36970001459121704,
        -0.47576001286506653, -1.215939998626709, 0.3750999867916107,
        -0.7911800146102905, 0.4576199948787689, 0.2223999947309494],
        [-1.4165199995040894, -0.45173999667167664, -0.3942199945449829,
        -0.507070004940033, -1.1479500532150269, -0.8170700073242188,
        -0.6508100032806396, -0.9143999814987183, 0.055229999125003815,
        -0.013650000095367432, 1.5211900472640991, -1.7079299688339233,
        0.8627300262451172, 1.3429900407791138, -0.06505999714136124,
        -0.6665499806404114], [0.9231200218200684, 0.6071500182151794,
        0.2472900003194809, 1.6211800575256348, 0.09144999831914902,
        1.5280699729919434, 0.5797799825668335, 0.8230199813842773,
        0.24506999552249908, -0.5227199792861938, 0.16176000237464905,
        -0.7383300065994263, -0.7865300178527832, 2.1809499263763428,
        0.052000001072883606, -1.383579969406128]], [[0.31147000193595886,
        -2.1389999389648438, -1.0254299640655518, 0.4763999879360199,
        -0.3124600052833557, -0.5622599720954895, 0.3170599937438965,
        -0.19401000440120697, -0.23316000401973724, -1.2023899555206299,
        0.5669400095939636, 0.03254999965429306, 0.10657999664545059,
        -0.6723399758338928, -0.1407800018787384, 0.7316700220108032],
        [0.8564800024032593, -0.7246000170707703, 0.6574900150299072,
        -0.17915000021457672, -0.6095100045204163, -0.09305000305175781,
        -0.3858500123023987, 0.7172600030899048, -1.1302200555801392,
        -0.9507899880409241, -1.1075899600982666, -1.2974300384521484,
        -0.4817900061607361, -0.2932099997997284, 0.17851999402046204,
        0.6967800259590149], [-1.8992400169372559, 0.4241099953651428,
        0.12646999955177307, -0.18147000670433044, 1.0651999711990356,
        -0.932479977607727, 0.8500999808311462, -0.038350000977516174,
        -0.5688300132751465, 0.6805599927902222, 0.6212400197982788,
        -0.2882699966430664, -0.2144400030374527, 0.09927000105381012,
        -2.344939947128296, -0.827180027961731], [-1.5081100463867188,
        -0.43035000562667847, 0.40362998843193054, 1.1835399866104126,
        0.1083500012755394, 0.6853100061416626, 0.2766200006008148,
        1.180899977684021, -0.20340999960899353, -0.18564000725746155,
        -1.2139099836349487, -0.4136100113391876, -1.0759899616241455,
        1.3291300535202026, 0.8993800282478333, -1.5520800352096558]]],
        'lse':
        [[10.87349, 10.88195, 10.87655, 10.88522], [10.87393, 10.86952,
        10.87967, 10.88702], [10.87987, 10.87195, 10.89201, 10.89001],
        [10.88306, 10.88119, 10.88775, 10.87841], [10.86923, 10.87978,
        10.87569, 10.89296], [10.86634, 10.88534, 10.88417, 10.88185],
        [10.87018, 10.87992, 10.87559, 10.88628], [10.86908, 10.88131,
        10.88603, 10.88664], [10.8828, 10.88422, 10.87707, 10.8892]],
        'top1':
        [[11227, 21301, 4613, 21545], [13952, 10357, 30666, 7989], [7800,
        10502, 5373, 31685], [9003, 45, 4913, 6243], [11518, 21301, 4613,
        27046], [30395, 24519, 15323, 15216], [1157, 17208, 1287, 28396],
        [30395, 18831, 9227, 8317], [11227, 20741, 29067, 16302]],
        'margin':
        [[0.34163, 0.66231, 0.41447, 0.11043], [0.00029, 0.0528, 0.0474,
        0.26052], [0.16481, 0.15778, 0.04031, 1.25182], [0.09724, 0.37066,
        0.03262, 0.11046], [0.54691, 0.33277, 0.00721, 0.36696], [0.30272,
        0.03624, 0.18758, 0.64555], [0.12905, 0.42984, 0.38134, 0.19127],
        [0.04976, 0.1497, 0.13941, 0.10368], [0.09562, 0.02806, 0.10999,
        0.24656]],
    },
    'deepseek-v2-236b': {
        'logits':
        [[[1.0131800174713135, -0.16866999864578247, 0.4271799921989441,
        2.7059199810028076, -1.6041200160980225, -0.5949599742889404,
        0.03888000175356865, 0.5207899808883667, -1.1234300136566162,
        -0.31711000204086304, -0.36733001470565796, -0.5119900107383728,
        0.6481299996376038, 0.9046400189399719, 0.6148800253868103,
        0.20198999345302582], [-0.8189600110054016, -2.29328989982605,
        0.441210001707077, 0.03523999825119972, 0.8624699711799622,
        1.6140600442886353, -0.2532599866390228, -0.5257800221443176,
        -0.2488500028848648, -0.49379000067710876, -0.5965399742126465,
        0.45353999733924866, -0.8601899743080139, 0.16906000673770905,
        0.9398800134658813, 1.5411900281906128], [-1.8369899988174438,
        -0.5623499751091003, -0.19547000527381897, 0.4021899998188019,
        0.840749979019165, 0.20541000366210938, 0.16110000014305115,
        0.5229499936103821, 1.1559300422668457, 0.6281999945640564,
        -0.7136499881744385, 0.6450899839401245, -2.281290054321289,
        1.8624399900436401, 0.13333000242710114, -0.6866899728775024],
        [0.8549500107765198, -0.42320001125335693, 2.1117000579833984,
        2.162519931793213, -0.03959000110626221, -0.5933700203895569,
        -0.0028099999763071537, -0.12926000356674194, -0.0775500014424324,
        0.1612199991941452, 0.11901000142097473, -1.9360500574111938,
        0.335970014333725, -0.3749200105667114, -0.8640999794006348,
        -1.2393499612808228]], [[-0.4504300057888031, -1.2472200393676758,
        -0.15310999751091003, 1.0570199489593506, -1.2330000400543213,
        0.47453001141548157, 0.5941900014877319, -0.17497000098228455,
        -0.6209400296211243, -1.2307499647140503, 0.4325999915599823,
        0.8978599905967712, -1.383870005607605, 0.17267000675201416,
        -0.3005000054836273, -0.17470000684261322], [-0.17117999494075775,
        -1.3028299808502197, 0.19697999954223633, -0.4683600068092346,
        0.7343699932098389, 0.31836000084877014, 0.889490008354187, -0.5625,
        0.7369099855422974, 0.8795499801635742, -1.0398499965667725,
        -0.3738099932670593, 1.4167100191116333, 2.025170087814331,
        0.8915600180625916, 0.21096999943256378], [0.4014900028705597,
        -0.060600001364946365, 0.002259999979287386, 0.8200200200080872,
        1.4272500276565552, 0.458840012550354, -0.8009600043296814,
        -0.11635000258684158, -0.7210999727249146, 0.09714999794960022,
        0.742389976978302, 0.44032999873161316, 1.5384399890899658,
        1.0668400526046753, -2.2516798973083496, -1.345639944076538],
        [0.5071499943733215, -0.42904001474380493, 1.936560034751892,
        0.7604100108146667, -0.4027099907398224, 0.8481199741363525,
        0.20507000386714935, -0.3425700068473816, 0.8683900237083435,
        -0.03505999967455864, 0.1160999983549118, -0.816290020942688,
        -1.0413099527359009, -0.4574599862098694, -0.5806099772453308,
        -1.300379991531372]], [[0.4571099877357483, -0.35231998562812805,
        -0.6543899774551392, 1.4300800561904907, -0.7509899735450745,
        -0.9731199741363525, -1.6867200136184692, 1.1449600458145142,
        -0.6417700052261353, -1.5325299501419067, -1.5508500337600708,
        -1.9112299680709839, -0.4731900095939636, 1.2148100137710571,
        -0.724049985408783, -0.24494999647140503], [-1.404039978981018,
        0.25352001190185547, 0.9164599776268005, 1.25586998462677,
        1.2869199514389038, 1.045799970626831, 0.6208999752998352,
        0.34033000469207764, 0.28918999433517456, -1.209030032157898,
        -0.21775999665260315, -0.4961099922657013, -0.7242000102996826,
        0.2236199975013733, 1.1927000284194946, 0.2449900060892105],
        [0.0221599992364645, 0.27167999744415283, 0.6857500076293945,
        -0.43942001461982727, 0.3448199927806854, -0.4728499948978424,
        -1.496209979057312, -0.736739993095398, 0.11439000070095062,
        0.8690000176429749, -0.3713200092315674, 0.40424999594688416,
        0.2519800066947937, 0.7454800009727478, -0.9111899733543396,
        -0.82669997215271], [1.0555499792099, -1.397439956665039,
        0.009050000458955765, 0.3233500123023987, 0.8913499712944031,
        0.12038999795913696, -1.1670299768447876, -0.7590299844741821,
        -1.3833099603652954, 0.04994000121951103, -0.9850500226020813,
        -0.7185199856758118, 1.4345099925994873, -3.355600118637085,
        -0.42537999153137207, -2.080159902572632]], [[0.39423999190330505,
        0.011529999785125256, 0.8344900012016296, 2.099940061569214,
        0.7179800271987915, -0.561739981174469, 1.0197900533676147,
        1.1305099725723267, -2.061769962310791, -0.1114799976348877,
        1.0441299676895142, 0.2519499957561493, -0.9724299907684326,
        -1.2086800336837769, -0.32541999220848083, -1.2966200113296509],
        [0.24237999320030212, -1.3091399669647217, 0.11862000077962875,
        0.02734999917447567, 0.4765399992465973, -0.296640008687973,
        0.10802000015974045, -0.3178899884223938, -0.17768999934196472,
        -0.5987899899482727, 0.28832000494003296, 0.2365500032901764,
        0.1010499969124794, 0.9769799709320068, 0.025550000369548798,
        -0.8607500195503235], [-0.566510021686554, 1.561669945716858,
        1.3469500541687012, -0.08720999956130981, 3.163450002670288,
        1.930109977722168, 1.2733299732208252, 0.28174999356269836,
        0.7236899733543396, -0.6629400253295898, 0.21920999884605408,
        -0.606190025806427, 0.338019996881485, 0.758679986000061,
        1.4728000164031982, -0.874180018901825], [-0.6850100159645081,
        1.0973800420761108, 1.35385000705719, -0.9499300122261047,
        0.8332599997520447, 2.1054599285125732, 1.2501399517059326,
        -1.1010700464248657, 0.004860000219196081, 1.4172799587249756,
        0.38451001048088074, 0.06154000014066696, 0.12218999862670898,
        -1.6933599710464478, -0.41130000352859497, -0.7622100114822388]],
        [[0.2727600038051605, -0.15473000705242157, -0.39403000473976135,
        1.148900032043457, -0.2756600081920624, 0.3465900123119354,
        -0.9134799838066101, 0.6594099998474121, -2.251729965209961,
        1.4303200244903564, -1.830739974975586, -0.8843299746513367,
        1.160730004310608, -0.37525999546051025, -1.4269599914550781,
        -0.9729599952697754], [-0.06419000029563904, -1.1998800039291382,
        0.9653800129890442, 1.7359600067138672, 1.1313600540161133,
        0.3436200022697449, 0.3278200030326843, 0.24991999566555023,
        1.7419899702072144, -0.15795999765396118, 0.7043600082397461,
        -0.5557500123977661, 0.9723799824714661, 1.3915599584579468,
        0.8519099950790405, -0.687279999256134], [-1.2653100490570068,
        -0.3743399977684021, -0.3750399947166443, -1.8438700437545776,
        0.8890799880027771, -1.9843800067901611, -1.2368299961090088,
        1.1658400297164917, 0.7788199782371521, -0.49869999289512634,
        -0.9615700244903564, 1.4982999563217163, -0.8883699774742126,
        -0.6955100297927856, -0.23617999255657196, -0.8614400029182434],
        [0.3618200123310089, 0.25014999508857727, -0.18971000611782074,
        -0.25731000304222107, 0.9799299836158752, 0.10972999781370163,
        -0.9466800093650818, -1.0689799785614014, -0.4304099977016449,
        -1.4914699792861938, -0.4692699909210205, -0.7093999981880188,
        -0.37674999237060547, -0.17538000643253326, -0.18830999732017517,
        -0.44165000319480896]], [[0.2699899971485138, 0.13446000218391418,
        -1.0438499450683594, 1.9635299444198608, -2.001310110092163,
        -0.600130021572113, -0.9860799908638, 1.0492600202560425,
        0.18807999789714813, -0.7141799926757812, 0.33834001421928406,
        -1.1441199779510498, -1.5633900165557861, 0.2506299912929535,
        -0.5109400153160095, -0.9929199814796448], [2.9073100090026855,
        -0.6699299812316895, 1.3375300168991089, -1.3439099788665771,
        0.06719999760389328, 0.08959999680519104, 1.244570016860962,
        0.05552000179886818, 0.06998000293970108, -0.26072001457214355,
        -0.04129000008106232, -1.8809499740600586, -0.3555000126361847,
        0.6797199845314026, 0.9555400013923645, 1.644610047340393],
        [-1.0679199695587158, -0.7510300278663635, 1.0554499626159668,
        -1.2992099523544312, 1.1339499950408936, -0.14967000484466553,
        0.6640300154685974, 0.011620000004768372, -1.0592600107192993,
        -0.2601900100708008, -1.4243500232696533, 0.13149000704288483,
        0.4790099859237671, 1.4043999910354614, 0.15399999916553497,
        0.011699999682605267], [1.936400055885315, -0.2886500060558319,
        1.4318000078201294, 0.5017899870872498, -1.6420700550079346,
        0.9916499853134155, -0.6159499883651733, -0.9186300039291382,
        0.5641800165176392, 0.8101999759674072, 0.5312100052833557,
        -0.4447700083255768, 0.6043800115585327, 0.29923999309539795,
        -1.0559500455856323, -0.8241000175476074]], [[0.8113499879837036,
        1.352620005607605, 0.7491700053215027, 3.5261099338531494,
        0.427949994802475, 0.38040998578071594, -0.654009997844696,
        1.3835200071334839, -1.0462299585342407, -0.2318899929523468,
        -0.677299976348877, 1.3847800493240356, 0.23455999791622162,
        -0.6943100094795227, 0.36695000529289246, -0.4631600081920624],
        [1.3541300296783447, -0.9466999769210815, -0.227960005402565,
        0.33594000339508057, -0.5523899793624878, 0.04397999867796898,
        0.5072900056838989, -1.3884899616241455, 0.570609986782074,
        0.6208599805831909, -0.8297600150108337, -0.2792699933052063,
        0.8876500129699707, -0.8974199891090393, 0.25578999519348145,
        0.8642500042915344], [-0.28255999088287354, 1.242900013923645,
        -1.6821500062942505, 0.2459000051021576, 0.42778000235557556,
        1.9951800107955933, 2.0903899669647217, -1.1059199571609497,
        -1.0820300579071045, -1.3117799758911133, -1.0088399648666382,
        -0.2584399878978729, -0.3691500127315521, 1.6792199611663818,
        0.01795000024139881, 1.1048699617385864], [1.8910200595855713,
        0.24759000539779663, -0.13244999945163727, -2.240489959716797,
        0.23631000518798828, 2.6982901096343994, -0.5774099826812744,
        -0.9897599816322327, -1.7983299493789673, 0.4329099953174591,
        -0.4589099884033203, -0.2561100125312805, 0.9671499729156494,
        -2.4809799194335938, -0.11410000175237656, -1.220479965209961]],
        [[1.34893000125885, -0.006089999806135893, -1.634850025177002,
        3.4874000549316406, -2.207750082015991, -0.2991499900817871,
        -1.68982994556427, -0.031300000846385956, 0.241689994931221,
        -0.0594400018453598, 0.6039299964904785, 0.03102000057697296,
        -0.15881000459194183, 0.9607499837875366, -0.039250001311302185,
        0.18897999823093414], [-1.1235400438308716, -1.9625099897384644,
        0.6342499852180481, -0.11552999913692474, -1.6706600189208984,
        0.052400000393390656, -0.8460900187492371, 0.354420006275177,
        0.43990999460220337, 0.19981999695301056, -0.48159000277519226,
        -0.46434998512268066, 0.08421000093221664, -0.22074000537395477,
        0.8220599889755249, 1.080839991569519], [0.17091000080108643,
        -0.0012600000482052565, -0.3768399953842163, -1.7187000513076782,
        0.7288100123405457, 1.2081700563430786, -0.016620000824332237,
        -0.16482000052928925, 0.32523998618125916, -0.7241600155830383,
        0.5666400194168091, -0.30395999550819397, -0.3109300136566162,
        0.706250011920929, -0.08316999673843384, -0.693310022354126],
        [0.35558000206947327, 1.4968500137329102, 2.589329957962036,
        1.429919958114624, 0.16675999760627747, 0.7394899725914001,
        -0.30281999707221985, -0.3852599859237671, 0.24470999836921692,
        1.2216299772262573, 1.7430399656295776, 0.26436999440193176,
        -0.0737299993634224, -2.2328898906707764, -1.4381500482559204,
        -0.41367998719215393]], [[1.2093700170516968, -0.3644300103187561,
        -0.3711099922657013, 1.6315699815750122, -0.8346800208091736,
        1.5404599905014038, 0.8235599994659424, 0.5990700125694275,
        -0.5894500017166138, -0.09453999996185303, -0.3572700023651123,
        0.3517700135707855, 0.16633999347686768, -0.10859999805688858,
        0.5038400292396545, 0.24020999670028687], [2.3298699855804443,
        -0.7561900019645691, -0.3422299921512604, 0.9574999809265137,
        0.9528999924659729, -0.08359000086784363, 1.6359699964523315,
        -0.2563599944114685, 0.25606000423431396, 0.3466399908065796,
        1.1452399492263794, -0.7857300043106079, 0.6128699779510498,
        0.6573600172996521, 0.8966699838638306, 2.0388801097869873],
        [-1.716130018234253, 0.41903001070022583, 1.3532700538635254,
        -0.609279990196228, 2.276930093765259, 0.08720999956130981,
        0.47738999128341675, 0.11429999768733978, -0.42774999141693115,
        -0.6637300252914429, 1.0410300493240356, -0.20424999296665192,
        0.241799995303154, 1.7168400287628174, 1.0782300233840942,
        -0.445279985666275], [0.9390400052070618, 0.14168000221252441,
        0.6080399751663208, 2.160979986190796, -0.5333600044250488,
        0.04247000068426132, 0.8829699754714966, 0.22878000140190125,
        -1.4926300048828125, 1.0618799924850464, 0.4023599922657013,
        0.13489000499248505, 0.3525499999523163, -2.2192699909210205,
        -0.39520999789237976, 1.0801399946212769]]],
        'lse':
        [[12.03185, 12.0379, 12.03916, 12.03805], [12.04298, 12.03695,
        12.03982, 12.0428], [12.04192, 12.04132, 12.03925, 12.0315],
        [12.04839, 12.03772, 12.04534, 12.03689], [12.04976, 12.03491,
        12.03655, 12.03988], [12.03897, 12.04153, 12.04092, 12.03125],
        [12.03653, 12.03607, 12.03732, 12.04492], [12.03845, 12.04012,
        12.03984, 12.03378], [12.04135, 12.03781, 12.03391, 12.04192]],
        'top1':
        [[96383, 96115, 66194, 46806], [28955, 6100, 84238, 84045], [93587,
        90583, 17875, 97044], [28408, 93149, 82987, 46071], [36907, 93149,
        57078, 46640], [81541, 39944, 2322, 48429], [17147, 82816, 15054,
        40060], [44157, 69924, 26702, 42352], [79438, 77336, 18263, 4181]],
        'margin':
        [[0.2494, 0.06103, 0.05667, 0.27843], [0.11618, 0.17623, 0.7757,
        0.04479], [0.25716, 0.21515, 0.03374, 0.30634], [0.18313, 0.01935,
        1.2439, 0.31365], [0.03379, 0.30827, 0.05613, 0.10841], [0.15134,
        0.01429, 0.51481, 0.12715], [0.07267, 0.77213, 0.93078, 0.26966],
        [0.34599, 0.10215, 0.00398, 0.32292], [0.28933, 0.04879, 0.20625,
        0.06621]],
        'experts':
        [[[[32, 49, 103, 114, 150, 152], [12, 19, 26, 49, 113, 152], [19,
        70, 105, 113, 114, 116], [11, 32, 113, 114, 116, 145], [12, 22, 69,
        114, 150, 152], [84, 86, 109, 113, 115, 133], [19, 24, 26, 37, 113,
        159], [1, 81, 92, 114, 115, 155], [24, 25, 56, 86, 150, 155], [19,
        37, 67, 140, 141, 155], [37, 57, 67, 86, 140, 157], [0, 19, 40, 86,
        88, 157], [50, 56, 57, 67, 95, 140], [24, 84, 95, 98, 141, 157],
        [24, 40, 88, 95, 116, 145], [57, 98, 116, 141, 145, 155], [57, 63,
        92, 95, 141, 150], [14, 24, 25, 49, 157, 159], [14, 50, 57, 86, 88,
        113], [24, 63, 88, 95, 113, 155], [5, 11, 19, 43, 141, 151], [0, 24,
        86, 92, 107, 157], [66, 78, 88, 95, 150, 151], [2, 95, 113, 141,
        145, 155], [1, 11, 24, 78, 95, 100], [6, 22, 43, 57, 95, 157], [10,
        25, 83, 131, 138, 150], [13, 40, 62, 84, 88, 150], [22, 24, 42, 43,
        92, 100], [21, 24, 54, 94, 138, 151], [19, 24, 41, 97, 128, 145],
        [4, 42, 78, 92, 95, 157], [25, 56, 66, 81, 92, 117], [0, 56, 59, 63,
        66, 81], [56, 59, 66, 92, 101, 115], [0, 8, 16, 59, 89, 140], [19,
        23, 25, 59, 66, 155], [13, 25, 59, 66, 139, 151], [5, 25, 66, 115,
        151, 155], [8, 19, 36, 46, 66, 151], [0, 18, 19, 89, 106, 142], [14,
        25, 94, 126, 139, 151], [0, 5, 14, 15, 101, 151], [0, 18, 23, 25,
        73, 78], [0, 12, 15, 19, 46, 107], [5, 8, 19, 51, 86, 146], [5, 8,
        19, 22, 25, 59], [19, 25, 41, 113, 135, 140], [5, 11, 19, 23, 94,
        141], [8, 18, 19, 66, 73, 140], [5, 29, 51, 66, 116, 151], [8, 19,
        41, 66, 100, 143], [8, 11, 19, 41, 46, 143], [8, 19, 56, 94, 140,
        153], [15, 19, 20, 59, 75, 113], [11, 12, 15, 46, 51, 86], [8, 19,
        26, 46, 55, 115], [8, 15, 41, 86, 116, 121], [9, 14, 15, 19, 33,
        61], [6, 11, 13, 14, 19, 25], [15, 19, 45, 46, 57, 76], [15, 24, 27,
        30, 68, 83], [15, 30, 41, 66, 68, 152], [30, 41, 107, 116, 158,
        159], [54, 82, 83, 110, 115, 128], [48, 82, 86, 104, 110, 115], [8,
        82, 87, 106, 110, 151], [22, 26, 52, 57, 116, 139], [22, 25, 26, 48,
        82, 104], [22, 24, 26, 57, 82, 117], [22, 24, 52, 57, 135, 159],
        [22, 57, 61, 72, 117, 139], [22, 57, 72, 101, 110, 153], [22, 72,
        78, 108, 110, 115], [25, 28, 108, 110, 117, 127], [26, 28, 33, 54,
        82, 117], [4, 33, 72, 108, 146, 159], [22, 24, 26, 62, 107, 143],
        [22, 24, 33, 106, 107, 117], [27, 43, 47, 48, 107, 117], [57, 62,
        108, 118, 124, 144], [4, 28, 33, 65, 73, 117], [8, 26, 28, 53, 62,
        108], [1, 4, 28, 36, 61, 77], [52, 84, 108, 132, 147, 151], [12, 26,
        28, 76, 83, 125], [25, 33, 77, 84, 117, 128], [4, 33, 43, 52, 120,
        146], [28, 36, 73, 108, 146, 148], [26, 33, 52, 95, 110, 146], [33,
        48, 57, 61, 108, 109], [33, 48, 82, 88, 117, 141], [0, 27, 48, 52,
        146, 151], [27, 48, 52, 84, 108, 159], [52, 57, 68, 82, 84, 85], [4,
        33, 68, 82, 105, 108], [15, 23, 34, 50, 55, 76], [23, 55, 66, 99,
        101, 106], [23, 30, 66, 80, 102, 140], [11, 19, 23, 55, 66, 102],
        [17, 23, 25, 51, 83, 146], [11, 28, 42, 94, 118, 125], [28, 42, 59,
        80, 83, 101], [5, 17, 94, 99, 102, 128], [17, 23, 57, 69, 114, 140],
        [5, 17, 26, 30, 57, 115], [17, 18, 50, 73, 127, 146], [25, 28, 34,
        35, 55, 102], [11, 13, 50, 59, 94, 114], [6, 13, 20, 28, 59, 94],
        [14, 23, 59, 119, 128, 151], [25, 33, 57, 98, 128, 130], [32, 42,
        60, 94, 127, 131], [28, 45, 50, 53, 66, 98], [6, 23, 35, 42, 119,
        128], [5, 50, 86, 89, 100, 119], [28, 32, 86, 89, 94, 137], [5, 23,
        42, 64, 73, 128], [8, 22, 23, 57, 79, 89], [14, 23, 55, 94, 128,
        148], [42, 50, 59, 74, 82, 94], [21, 50, 78, 83, 119, 128], [22, 23,
        53, 73, 128, 148], [5, 11, 69, 104, 125, 128], [5, 15, 23, 50, 82,
        127], [5, 28, 83, 86, 102, 123], [8, 29, 33, 60, 94, 128], [57, 80,
        86, 92, 104, 123]]], [[[1, 24, 43, 50, 97, 155], [15, 33, 83, 86,
        107, 122], [24, 57, 82, 110, 124, 146], [21, 23, 45, 66, 83, 94]]],
        [[[22, 43, 57, 89, 100, 128], [0, 15, 19, 42, 83, 126], [0, 62, 66,
        68, 72, 141], [14, 20, 44, 57, 83, 128]]], [[[24, 35, 40, 41, 78,
        92], [15, 24, 30, 41, 83, 152], [4, 52, 61, 82, 108, 141], [40, 55,
        62, 74, 83, 128]]], [[[5, 60, 78, 95, 100, 151], [13, 14, 15, 41,
        92, 99], [0, 4, 51, 82, 84, 86], [6, 21, 59, 83, 121, 128]]], [[[19,
        24, 30, 78, 145, 151], [13, 15, 19, 50, 151, 159], [4, 33, 61, 108,
        128, 146], [5, 6, 8, 74, 128, 152]]], [[[17, 24, 56, 78, 138, 157],
        [13, 26, 30, 90, 94, 145], [0, 36, 84, 108, 124, 141], [11, 16, 60,
        83, 112, 121]]], [[[25, 78, 92, 94, 151, 157], [15, 19, 50, 86, 153,
        158], [25, 48, 82, 125, 146, 158], [28, 29, 60, 80, 110, 128]]],
        [[[11, 14, 19, 20, 57, 75], [12, 15, 19, 33, 41, 138], [12, 61, 84,
        108, 146, 151], [25, 44, 57, 59, 83, 147]]]],
    },
}


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even
    (finite inputs)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
            ).astype(np.uint16)


def dlrm_numpy_params(shapes: dict, seed: int) -> dict:
    """DLRM weights drawn by numpy from ``seed`` for a parameter tree of
    ``shapes`` (``{"tables": (T, R, D), "bot": {name: shape}, "top":
    {...}}`` in the models' leaf order): tables 0.02 * N(0, 1) (the models'
    rule), MLP weights He-normal (std sqrt(2 / fan_in)) and biases 0.1 *
    N(0, 1), so that the activations keep their scale through the 19 ReLU
    layers and the logits are of order 1, where a tolerance on them bites.
    The tables come as bf16 bit patterns (uint16), the rest float32.  The
    JAX reference (``scripts/port_reference_times.py``) and the port are
    fed the same bits."""
    rng = np.random.default_rng(seed)
    T, R, D = shapes["tables"]
    tables = np.empty((T, R, D), np.uint16)
    for t in range(T):
        tables[t] = bf16_bits(0.02 * rng.standard_normal((R, D), np.float32))
    tree = {"tables": tables}
    for part in ("bot", "top"):
        tree[part] = {}
        for name, shape in shapes[part].items():
            std = np.sqrt(2.0 / shape[0]) if len(shape) == 2 else 0.1
            tree[part][name] = (rng.standard_normal(shape, np.float32)
                                * np.float32(std))
    return tree


# per-channel leaves drawn at 0.1: norm scales and biases, and the
# recurrent blocks' vectors (Mamba-2's A_log, dt_bias, D_skip, conv_b;
# RWKV-6's w0, u, lerp mixes mu_*, group-norm ln_scale, ln_bias).  Every
# decay stays in (0, 1) at any value: Mamba-2's exp(dt * -exp(A_log)) with
# dt = softplus(.) > 0, RWKV-6's exp(-exp(w0 + lora))
_SMALL_LEAVES = ("scale", "bias", "ln_scale", "ln_bias", "conv_b", "dt_bias",
                 "A_log", "D_skip", "w0", "u")
# leaves drawn around a mean other than 0: Mamba-2's dt_bias about
# softplus^-1(0.01) = -4.6, so that dt = softplus(dt_bias + x w) spans
# about the [0.001, 0.1] that Mamba-2's own init draws (at a mean of 0 dt
# is about 0.7, and a random stack amplifies its bf16 roundings about
# 1.85x a layer: PERF.md §6)
_LEAF_MEAN = {"dt_bias": -4.6}


def _fan_in(name: str, shape: tuple, parent: str = "") -> int:
    """The true fan-in of a transformer weight (``shape`` may lead with a
    layers dim): the product of the dims a forward contracts (the
    reference's init takes ``shape[-2]``, which for ``wq``/``wk``/``wv``
    (D, H, Dh) is the head count).  Attention's (``attn``) ``wq``, ``wk``,
    ``wv`` and MLA's ``wq_b``, ``wkv_b`` (r, H, e) contract their first
    dim, ``wo`` (H, Dh, D) its first two; the Mamba-2 and RWKV-6 blocks'
    matrices (under ``mixer`` and ``ffn``: (in, out), the conv's (k, C))
    and every other matrix, the expert stacks (E, D, F) and (E, F, D)
    included, their next to last."""
    if parent in ("mixer", "ffn"):
        return shape[-2]
    if name in ("wq", "wk", "wv", "wq_b", "wkv_b"):
        return shape[-3]
    if name == "wo":
        return shape[-3] * shape[-2]
    return shape[-2]


def _init_std(name: str, shape: tuple, parent: str = "") -> float:
    """The standard deviation of a transformer weight's draw: ``embed``
    0.02, per-channel leaves (``_SMALL_LEAVES``, ``mu_*``) 0.1, every
    matrix 1 / sqrt(true fan-in)."""
    if name == "embed":
        return 0.02
    if name in _SMALL_LEAVES or name.startswith("mu_"):
        return 0.1
    return 1.0 / np.sqrt(_fan_in(name, shape, parent))


def transformer_numpy_params(tree, seed: int, bf16: bool):
    """Transformer weights drawn by numpy from ``seed`` for a parameter tree
    whose leaves are shapes (dicts walked in sorted key order, lists in
    order, so either package's tree gives the same draws): ``embed``
    0.02 * N(0, 1), norm scales and biases 0.1 * N(0, 1), every matrix
    N(0, 1) / sqrt(true fan-in), stacked leaves drawn one layer at a time.
    At the true fan-in the activations keep their scale through the
    layers, so that rounding differences stay rounding differences (with
    the reference's fan-in rule, decode at full depth is chaotic: an ulp
    in layer 1 decides the top token at layer 22).  Leaves are bf16 bit
    patterns (uint16) when ``bf16``, else float32; the JAX reference
    (``scripts/port_reference_times.py``) and the port are fed the same
    bits."""
    rng = np.random.default_rng(seed)

    def draw(name, shape, parent):
        std = _init_std(name, shape, parent)
        mean = np.float32(_LEAF_MEAN.get(name, 0.0))
        out = np.empty(shape, np.uint16 if bf16 else np.float32)
        parts = out if len(shape) >= 3 else (out,)
        for part in parts:
            x = rng.standard_normal(part.shape, np.float32) * np.float32(std)
            x = x + mean if mean else x
            part[...] = bf16_bits(x) if bf16 else x
        return out

    def walk(node, name, parent):
        if isinstance(node, dict):
            return {k: walk(node[k], k, name) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v, name, parent) for v in node]
        return draw(name, tuple(node), parent)
    return walk(tree, "", "")


def hashed_bf16(shape: tuple, seed: int, std: float, device,
                block: int = 1 << 26, mean: float = 0.0):
    """A bf16 tensor of ``shape`` on ``device`` whose element i is a
    counter-based integer hash of (i, ``seed``) mapped to a uniform value
    on [-std * sqrt(3), std * sqrt(3)) (the variance of N(0, std^2)),
    plus ``mean``, and cut to bf16 by truncation.  Integer arithmetic, one
    exact float32 step, one float32 multiply and one add: the same bits on
    the card and on a CPU, in milliseconds on the card, where numpy's
    normal draws of a 9B model take minutes of host time."""
    import torch
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int16, device=device)
    scale = torch.tensor(np.float32(std * math.sqrt(3.0)), device=device)
    mask = 0xFFFFFFFF
    salt = (seed * 0x85EBCA6B) & mask
    for lo in range(0, n, block):
        i = torch.arange(lo, min(lo + block, n), dtype=torch.int64,
                         device=device)
        x = (i * 0x9E3779B1 + salt) & mask
        for _ in range(2):                  # the 32-bit integer hash
            x = (((x >> 16) ^ x) * 0x45D9F3B) & mask
        x = (x >> 16) ^ x
        u = (x >> 8).to(torch.float32) * (2.0 ** -23) - 1.0   # exact
        w = u * scale
        if mean:
            w = w + np.float32(mean)
        out[lo:lo + len(i)] = (w.view(torch.int32) >> 16).to(torch.int16)
    return out.view(torch.bfloat16).reshape(shape)


def hashed_params(tree, seed: int, device):
    """``transformer_numpy_params``' tree and scales (``embed`` 0.02,
    norm scales and biases 0.1, every matrix 1 / sqrt(true fan-in)) drawn
    by ``hashed_bf16`` instead, leaf k (dicts walked in sorted key order,
    lists in order) from seed ``seed * 1_000_003 + k``; the leaves of
    ``tree`` are shapes."""
    count = [0]

    def draw(name, shape, parent):
        count[0] += 1
        return hashed_bf16(shape, seed * 1_000_003 + count[0],
                           _init_std(name, shape, parent), device,
                           mean=_LEAF_MEAN.get(name, 0.0))

    def walk(node, name, parent):
        if isinstance(node, dict):
            return {k: walk(node[k], k, name) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v, name, parent) for v in node]
        return draw(name, tuple(node), parent)
    return walk(tree, "", "")


# the run's start, shared with the child phases through the environment
RUN_T0 = float(os.environ.setdefault("CHIP_SMOKE_T0", repr(time.time())))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    # the timeline on stderr: seconds since the run began, at each line
    print(f"chip_smoke t={time.time() - RUN_T0:.1f}s "
          f"{obj.get('phase', '-')} {obj.get('kernel', '')}".rstrip(),
          file=sys.stderr, flush=True)


def ptxas_summary(log: str) -> dict:
    """Kernel -> "N registers, S bytes spilled" from an ``nvcc -Xptxas -v``
    log (names shortened from the mangled ones)."""
    import re
    out = {}
    for mangled, body in re.findall(
            r"Compiling entry function '(\S+)' for 'sm_90a'(.*?)"
            r"(?=Compiling entry function|\Z)", log, re.S):
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
        name = mangled if m is None else mangled[
            m.end():m.end() + int(m.group(1))]
        targs = re.match(r"I(.*?)EE?v", mangled[m.end() + int(m.group(1)):]
                         if m else "")
        if targs:
            name += "<" + ",".join(re.findall(r"L[ib](\d+)E", targs.group(1))
                                   or [targs.group(1)]) + ">"
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        out[name] = (f"{regs.group(1) if regs else '?'} registers, "
                     f"{spill.group(1) if spill else '?'} bytes spilled")
    return out


def sass_counts(lib) -> dict:
    """Per kernel of a built library, its SASS instruction count and how
    many tensor-core products (HMMA), asynchronous global-to-shared copies
    (LDGSTS; UBLKCP, the 1D bulk copy; UTMALDG, the tensor-map copy) and
    ldmatrix loads (LDSM) it holds (``cuobjdump -sass``); {} where
    cuobjdump is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    out = {}
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name = next(iter(ptxas_summary(
            f"Compiling entry function '{part.split()[0]}' for 'sm_90a'")))
        out[name] = {"instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/",
                                                    part))}
        out[name].update({op: len(re.findall(r"\b" + op + r"\b", part))
                          for op in ("HMMA", "LDGSTS", "UBLKCP", "UTMALDG",
                                     "LDSM")})
    return out


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` of the per-call device time of ``inner``
    back-to-back calls between two CUDA events (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def host_us(fn, n: int = 200) -> float:
    """The host's µs per call of ``fn``, unsynchronised: where it is near
    the event time of ``cuda_ms``, that time is the host's enqueue rate and
    the card waits on the launches."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_us(fn, n: int = 50) -> float:
    """Mean device µs per call of ``fn``: the union of the device intervals
    (kernels, copies) of ``n`` back-to-back calls in a ``torch.profiler``
    trace, over n; a merge kernel that waits inside its split kernel is
    counted once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # after many profiler sessions in one process a trace now and then
    # comes back with device events missing (a busy time of a tenth of the
    # kernel's): trace again unless every call left at least one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if len(dev) >= n:
            return busy_us(dev) / n
    raise RuntimeError(f"the profiler recorded {len(dev)} device intervals "
                       f"for {n} calls")


def scalar_exhaustive(fn, which=None, chunk: int = 1 << 27) -> dict:
    """Every float32 bit pattern through each device scalar function
    (``fn(which, x_ptr, y_ptr, n, stream)``, the engine-step library's
    ``scalar_fn``) and through its plain version
    (``repro_torch.core.arith``), both on the card, ``chunk`` inputs at a
    time.  A mismatch is any difference in bits, except that any NaN
    equals any NaN.  ``which`` pairs the plain version's name with the
    device function's index (default ``ops.SCALAR_FNS``).  Returns name ->
    mismatches, the first few mismatching inputs (hex bits, device and
    plain outputs), seconds."""
    import torch
    from repro_torch.core import arith
    from repro_torch.kernels.engine_step import ops
    which = ops.SCALAR_FNS.items() if which is None else which
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    base = torch.arange(chunk, dtype=torch.int32, device=dev)
    y = torch.empty(chunk, dtype=torch.float32, device=dev)
    out = {}
    for name, idx in which:
        plain = getattr(arith, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bad, first = 0, []
        for lo in range(-(1 << 31), 1 << 31, chunk):
            x = (base + lo).view(torch.float32)
            if fn(idx, x.data_ptr(), y.data_ptr(), chunk, stream) != 0:
                raise RuntimeError(f"scalar_fn {idx}: launch failed")
            want = plain(x)
            same = (y.view(torch.int32) == want.view(torch.int32)) | (
                torch.isnan(y) & torch.isnan(want))
            n_bad = int((~same).sum())
            if n_bad:
                bad += n_bad
                for i in (~same).nonzero()[:8 - len(first), 0].tolist():
                    bits = int(x.view(torch.int32)[i]) & 0xffffffff
                    first.append([f"{bits:08x}", float(y[i]),
                                  float(want[i])])
        torch.cuda.synchronize()
        out[name] = {
            "inputs": 1 << 32, "mismatches": bad, "first": first,
            "seconds": time.perf_counter() - t0}
    return out



# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fused_case(policy, F: int, B: int, lossy: bool, seed: int, dev):
    """Random-but-plausible stage-1 inputs, state and per-lane params."""
    import torch
    from repro_torch.core import cc
    rng = np.random.default_rng(seed)
    H = 4
    hm = (rng.random((B, H, F)) < 0.7).astype(np.float32)
    hm[:, 0] = 1.0
    kmin = rng.uniform(2e5, 6e5, (B, 1, 1)) * np.ones((1, H, F))
    case = dict(
        q_d=rng.uniform(0, 3e6, (B, H, F)) * hm,
        tx_d=rng.uniform(0, 50e9, (B, H, F)) * hm,
        caps=rng.uniform(10e9, 50e9, (B, H, F)),
        ecn_mask=(rng.random((B, H, F)) < 0.8) * hm,
        hopmask=hm,
        kmin_h=kmin, kmax_h=kmin * 4.0,
        pmax_h=rng.uniform(0.1, 0.3, (B, 1, 1)) * np.ones((1, H, F)),
        base_rtt=rng.uniform(2e-6, 20e-6, (B, F)),
        line=np.full((B, F), 25e9),
        loss=(rng.uniform(0, 0.05, (B, F)) * (rng.random((B, F)) < 0.5)
              if lossy else np.zeros((B, F))),
    )
    case = {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                               device=dev) for k, v in case.items()}
    keys = cc.kernel_state_keys(policy)
    line = torch.full((F,), 25e9, dtype=torch.float32)
    ctx = cc.FlowCtx(line=line, bdp=line * 5e-6,
                     fanin=torch.full((F,), 4.0), n_flows=F)
    states = []
    for b in range(B):
        st = policy.init(ctx)
        st = {k: v * torch.as_tensor(rng.uniform(0.5, 1.5, F),
                                     dtype=torch.float32)
              for k, v in st.items()}
        for k in ("t_cut", "t_inc", "t_alpha", "t_rtt", "t_upd"):
            if k in st:
                st[k] = torch.as_tensor(rng.uniform(0, 3e-4, F),
                                        dtype=torch.float32)
        states.append(cc.pack_state(policy, st, n_flows=F))
    state = torch.stack(states).to(dev).contiguous()
    params = torch.stack([
        cc.pack_params(policy, {k: v * (1.0 + 0.15 * b)
                                for k, v in policy.params.items()
                                if not policy.spec[k].init_baked})
        for b in range(B)]).to(dev).contiguous()
    assert state.shape[1] == max(len(keys), 1)
    return case, state, params


def check_fused(dev, flows) -> dict:
    """The fused kernel against its plain version for every policy, lossy
    and lossless, at each flow count of ``flows`` and ``CHECK_LANES``, bit
    for bit; then once more at 1,500 flows with every input one float past
    a 16-byte boundary, so that the tile rows take the 4-byte cp.async
    route (as does every flow count that is not a multiple of 4)."""
    import torch
    from repro_torch.core import cc
    from repro_torch.kernels.engine_step import ops, ref
    n, vec = 0, 0
    for pi, name in enumerate(cc.ALL_POLICIES):
        policy = cc.get_policy(name)
        for lossy in (False, True):
            for F, shift in [(F, False) for F in flows] + [(1500, True)]:
                for B in CHECK_LANES:
                    case, state, params = fused_case(
                        policy, F, B, lossy, 1000 * pi + F + B + lossy, dev)
                    args = [*case.values(), state, params]
                    if shift:
                        args = [shifted_copy(x) for x in args]
                    vec += ops.vector_copies(
                        F, [x.data_ptr() for x in args[:12]])
                    got = ops.fused_signals_policy(policy, *args, 3.3e-4,
                                                   1e-5, DT)
                    want = ref.fused_signals_policy_ref(policy, *args,
                                                        3.3e-4, 1e-5, DT)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        if not torch.equal(g, w.expand_as(g)):
                            bad = int((g != w.expand_as(g)).sum())
                            raise AssertionError(
                                f"fused_signals_policy {name} lossy={lossy}"
                                f" F={F} B={B} shifted={shift}: {bad} "
                                "values differ from "
                                "the plain version")
                    n += 1
    return {"cases": n, "flows": list(flows), "unaligned_flows": 1500,
            "lanes": list(CHECK_LANES), "cp_async16_cases": vec,
            "cp_async4_cases": n - vec, "max_abs_err": 0.0,
            "tolerance": "bit-equal"}


def shifted_copy(x):
    """A copy of ``x`` whose storage starts one float past a 16-byte
    boundary."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def plan_inputs(sim) -> list:
    """``(what, strategy, plan arrays, input width)`` of each reduction of
    a prepared simulation's step, the soft cost's sum over flows on the
    card (``lane_sum``) included."""
    from repro_torch.core import engine
    from repro_torch.core.topology import MAXHOP
    plan, pp = sim.plan, sim.pp
    Fp, Lk = plan.n_flows_pad, plan.n_links
    named = [(f"hop{h}", plan.hop[h], pp["r_hop"][h], Fp)
             for h in range(MAXHOP)]
    lane_sum = engine._lane_sum_plan(plan, pp["line"].device)
    return named + [("qlink", plan.qlink, pp["r_qlink"], Fp * MAXHOP),
                    ("qport", plan.qport, pp["r_qport"], Fp * MAXHOP),
                    ("group", plan.group, pp["r_group"], Fp),
                    ("pause", plan.pause, pp["r_pause"], Lk),
                    ("qdev", plan.qdev, pp["r_qdev"], Lk),
                    ("lane_sum", *lane_sum, Fp)]


def gather_plans(sims: dict) -> list:
    """Every non-empty reduction plan of the prepared main-path
    scenarios, "gather" and split-row "gather2" alike, as ``(scenario,
    what, strategy, the segment kernels' plan arguments, input width)``."""
    from repro_torch.core import engine
    return [(label, what, strat, engine._kernel_plan(strat, arrs), n_in)
            for label, sim in sims.items()
            for what, strat, arrs, n_in in plan_inputs(sim)
            if strat[0] != "empty"]


def segment_launches(plan) -> tuple:
    """The segment kernels' launches one kernel-path step makes without
    the queue timeline: ``segment_reduce`` once for each non-empty plan
    but qport and once for the soft cost's sum over flows
    (``engine._lane_sum_plan``), ``segment_reduce_pfc`` once for qport."""
    plans = plan.hop + (plan.qlink, plan.group, plan.pause)
    return (sum(s[0] != "empty" for s in plans) + int(plan.n_flows > 0),
            int(plan.qport[0] != "empty"))


def check_segments(plans, dev) -> tuple:
    """Both segment kernels on every plan at ``CHECK_LANES`` lanes, and on
    lanes read through strides (every other element, as the step reads a
    hop's backlog), against their plain versions: the sums equal in bits,
    ``paused`` equal everywhere."""
    import torch
    from repro_torch.kernels.engine_step import ops, ref
    rng = np.random.default_rng(7)
    worst = {"segment_reduce": 0.0, "segment_reduce_pfc": 0.0}
    rows = []
    for label, what, strat, kplan, n_in in plans:
        idx, n_out, C, *split = kplan
        for B, strided in [(B, False) for B in CHECK_LANES] + [(3, True)]:
            x = (rng.uniform(0, 2e6, (B, n_in))
                 * (rng.random((B, n_in)) < 0.7))
            if strided:
                wide = np.zeros((B, 2 * n_in))
                wide[:, ::2] = x
                vals = torch.as_tensor(wide, dtype=torch.float32,
                                       device=dev)[:, ::2]
            else:
                vals = torch.as_tensor(x, dtype=torch.float32, device=dev)
            got = ops.segment_reduce(vals, *kplan)
            want = ref.segment_reduce_ref(vals, *kplan)
            worst["segment_reduce"] = max(worst["segment_reduce"], float(
                (got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"segment_reduce {label}/{what} {strat} B={B}: max abs "
                    f"err {float((got - want).abs().max())}")
            # PFC hysteresis around the reduced occupancy
            xoff = (want * torch.as_tensor(rng.uniform(0.5, 1.5, (B, n_out)),
                                           dtype=torch.float32, device=dev)
                    ).contiguous()
            xoff[:, ::3] = want[:, ::3]          # on the threshold
            xon = (xoff * 0.8).contiguous()
            can = torch.as_tensor(rng.random((B, n_out)) < 0.7, device=dev)
            prev = torch.as_tensor(rng.random((B, n_out)) < 0.5, device=dev)
            q, paused = ops.segment_reduce_pfc(vals, idx, n_out, C, xoff, xon,
                                               can, prev, *split)
            q_r, paused_r = ref.segment_reduce_pfc_ref(
                vals, idx, n_out, C, xoff, xon, can, prev, *split)
            worst["segment_reduce_pfc"] = max(worst["segment_reduce_pfc"],
                                              float((q - q_r).abs().max()))
            if not (torch.equal(q, q_r) and torch.equal(paused, paused_r)):
                raise AssertionError(
                    f"segment_reduce_pfc {label}/{what} {strat} B={B}: max "
                    f"abs err {float((q - q_r).abs().max())}, "
                    f"{int((paused != paused_r).sum())} paused differ")
        rows.append(f"{label}/{what} {strat} (n_in={n_in})")
    torch.cuda.synchronize()
    return worst, rows


def carry_leaves(carry, prefix=""):
    for k, v in carry.items():
        if isinstance(v, dict):
            yield from carry_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def check_batched_step(sim, cfg) -> dict:
    """Fig 12's 9 lanes driven ``FIG12_STEP_AT`` steps on the kernel path,
    then one more step from that state on each path: every float leaf of
    the carry within rtol 1e-5 + atol 1e-3 (the kernels' check tolerance,
    as ``tests/test_torch_kernels_cuda.py``), every flag equal.  Holds the
    fused and segment kernels at the batch's own shapes (B=9, its padded
    flows, its plans) against the op path on every lane."""
    import torch
    from repro_torch.core import engine, sweep
    pts = fig12_points()
    B = len(pts)
    fab = sweep._stack_fabric(sim.fabric, {
        "kmin": pts[:, 0], "kmax": pts[:, 1], "xoff": pts[:, 2]}, B)
    steps = {impl: engine._make_step(sim.policy, cfg, sim.plan, sim.pp, None,
                                     fab, impl == "cuda", lanes=B)
             for impl in ("cuda", "torch")}
    carry = engine._init_carry(sim.pp, sim.plan, sim.policy, cfg, None,
                               lanes=B)
    for it in range(FIG12_STEP_AT):
        carry = steps["cuda"](carry, it)
    if bool(engine._halted_lanes(carry).any()):
        raise AssertionError("batched_step_check: a lane halted before "
                             f"step {FIG12_STEP_AT}")
    got = steps["cuda"](engine._tree_map(torch.clone, carry), FIG12_STEP_AT)
    want = dict(carry_leaves(steps["torch"](
        engine._tree_map(torch.clone, carry), FIG12_STEP_AT)))
    torch.cuda.synchronize()
    leaves = equal = 0
    worst = 0.0
    for k, a in carry_leaves(got):
        w = want[k]
        leaves += 1
        same = bool(torch.equal(a, w))
        equal += same
        if same:
            continue
        if not a.is_floating_point():
            raise AssertionError(f"batched_step_check: {k} differs on "
                                 f"{int((a != w).sum())} elements")
        close = torch.isclose(a, w, rtol=1e-5, atol=1e-3)
        if not bool(close.all()):
            raise AssertionError(f"batched_step_check: {k}: "
                                 f"{int((~close).sum())} values beyond "
                                 "rtol 1e-5 + atol 1e-3")
        fin = torch.isfinite(w)
        worst = max(worst, float((a - w)[fin].abs().max()))
    pause = carry["pause_count"].sum(dim=-1)
    if not bool((pause > 0).any()):
        raise AssertionError("batched_step_check: no PAUSE in the state")
    return {"lanes": B, "flows_padded": sim.plan.n_flows_pad,
            "links": sim.plan.n_links, "step": FIG12_STEP_AT,
            "leaves": leaves, "leaves_bit_equal": equal,
            "max_abs_err": worst,
            "pause_frames_per_lane": pause.tolist(),
            "tolerance": "rtol 1e-5 + atol 1e-3; flags equal"}


def fused_bytes(F: int, K: int, P: int, rows: int | None = None) -> int:
    """Device bytes one fused launch must move for ``F`` flows: the input
    rows the policy's update reads (``rows``, ``ops.rows_read``; by
    default all of them, the 8 hop inputs over 4 hops, the 3 flat inputs
    and the K state rows) read once, the params, the state, rate and win
    written once."""
    rows = 8 * 4 + 3 + K if rows is None else rows
    return 4 * F * rows + 4 * P + 4 * F * (K + 2)


# float32 operations per flow of stages 1+2: the hop loop (about 60) and
# the policy's update (DCQCN about 60; mlp's four tanh units, two heads,
# sigmoid and exp about 200)
FUSED_FLOPS = {"dcqcn": 120, "mlp": 260}
# the cold times cycle over input sets that together exceed the 50 MB L2
FUSED_COLD_BYTES = 100e6
# the fused kernel's timed shapes: the serial path (the 128-GPU plan, one
# lane) and the lanes path (Fig 12's 9 lanes), under DCQCN and mlp; the
# row's own numbers are DCQCN's at B=1, the others carry a prefix
FUSED_TIMED = (("", "dcqcn", 1), ("mlp_", "mlp", 1), ("b9_", "dcqcn", 9),
               ("mlp_b9_", "mlp", 9))


def time_fused(s128, fig12, dev, traced: dict) -> dict:
    """Kernel vs plain time under DCQCN (the row's numbers) and ``mlp``
    (``mlp_*``) at the 128-GPU plan's padded flow count and B=1, and under
    both at Fig 12's padded flow count and B=9 (``b9_*``, ``mlp_b9_*``).
    ``ms`` is cold: direct launches cycling over input sets larger than
    the L2 together, so that no launch finds its inputs in the L2, as the
    engine step does; ``ms_hot`` repeats one set.  ``traced`` (row ->
    (its kernel's direct launch, its library call or None, the tensors
    they touch)) gets each cold launch for ``device_us`` at the end of the
    run; the launches pass raw pointers, so the tensors are held there."""
    import torch
    from repro_torch.core import cc
    from repro_torch.kernels.engine_step import ops, ref
    fn = ops.kernel_function("fused_signals_policy")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for prefix, name, B in FUSED_TIMED:
        policy = cc.get_policy(name)
        F = (s128 if B == 1 else fig12).plan.n_flows_pad
        sets, n_sets = [], 2
        while len(sets) < n_sets:
            case, state, params = fused_case(policy, F, B, name == "mlp",
                                             5 + len(sets), dev)
            K, P = state.shape[1], params.shape[1]
            n_bytes = B * fused_bytes(F, K, P, ops.rows_read(
                policy.kernel_id, K))
            n_sets = max(2, -(-int(FUSED_COLD_BYTES) // n_bytes))
            ins = (*case.values(), state, params)
            outs = (torch.empty_like(state), torch.empty_like(case["line"]),
                    torch.empty_like(case["line"]))
            sets.append(((ins, outs), ops.launch_args(
                policy.kernel_id, ins, outs, 3.3e-4, 1e-5, DT)))
        turn = [0]

        def launch(sets=sets, turn=turn):
            args = sets[turn[0] % len(sets)][1]
            turn[0] += 1
            if fn(*args, stream) != 0:
                raise RuntimeError("fused_signals_policy launch failed")

        def launch_hot(sets=sets):
            if fn(*sets[0][1], stream) != 0:
                raise RuntimeError("fused_signals_policy launch failed")
        row = {"ms": cuda_ms(launch), "ms_hot": cuda_ms(launch_hot),
               "host_us_per_launch": host_us(launch),
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                               B * FUSED_FLOPS[name] * F / F32_FLOPS) * 1e3,
               "shape": f"B={B} F={F} K={K} P={P} ({name})",
               "bytes": n_bytes, "cold_sets": len(sets)}
        if B == 1:
            ins = sets[0][0][0]
            row["plain_ms"] = cuda_ms(
                lambda: ref.fused_signals_policy_ref(policy, *ins, 3.3e-4,
                                                     1e-5, DT),
                reps=10 if name == "mlp" else 20, inner=2)
        if not prefix:
            row.update(bound_by="bytes", library_ms=None)
        out.update({prefix + k: v for k, v in row.items()})
        traced["fused_signals_policy" + (f"/{prefix[:-1]}" if prefix
                                         else "")] = (launch, None, sets)
    return out


# the segment kernels' timed plans: (kernel, key prefix, scenario, plan);
# each kernel row's own numbers are those of its first plan (the PAUSE
# tally of the 128-GPU step; the per-port reduction of the 32-GPU step),
# the split-row plans of the 128-GPU step carry a prefix
SEGMENT_TIMED = (("segment_reduce", "", "clos128_1d", "pause"),
                 ("segment_reduce", "qlink_", "clos128_1d", "qlink"),
                 ("segment_reduce_pfc", "", "clos32_2d", "qport"),
                 ("segment_reduce_pfc", "qport128_", "clos128_1d", "qport"))


def time_segment(key: str, name: str, sim, what: str, dev,
                 traced: dict) -> dict:
    """Event, host and plain times of one segment kernel on one plan of
    ``sim``, its byte bound and ``index_add_`` over the same values
    (``library_ms`` where it computes the same function: not for the PFC
    variant, whose hysteresis it lacks).  ``traced[key]`` gets the
    launch and ``index_add_`` for ``device_us`` at the end of the run."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.engine_step import ops, ref
    (strat, arrs, n_in), = [(s, a, n) for w, s, a, n in plan_inputs(sim)
                            if w == what]
    pfc = name == "segment_reduce_pfc"
    kplan = engine._kernel_plan(strat, arrs)
    idx, n_out, C, boff, C2, ctas = kplan
    rng = np.random.default_rng(11)
    vals = torch.as_tensor(rng.uniform(0, 2e6, (1, n_in)),
                           dtype=torch.float32, device=dev)
    out = torch.empty((1, n_out), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    # the input of each member, the segment of each input (n_out: none)
    members = idx.cpu().numpy().astype(np.int64)
    blk_seg = (np.arange(n_out) if boff is None else np.repeat(
        np.arange(n_out), np.diff(boff.cpu().numpy())))
    seg_of_slot = np.repeat(blk_seg, C)
    live = members < n_in
    seg_of = np.full(n_in, n_out, np.int64)
    seg_of[members[live]] = seg_of_slot[live]
    # bytes: the plan (member indices, block offsets, CTA table) and each
    # member's value read once, the sums written once
    n_bytes = (4 * idx.numel() + 4 * int(live.sum()) + 4 * n_out
               + sum(4 * x.numel() for x in (boff, ctas) if x is not None))
    args = ops.segment_args(vals, idx, boff, n_out, C, C2, ctas)
    if pfc:
        xoff = torch.full((1, n_out), 1e6, device=dev)
        xon = torch.full((1, n_out), 0.8e6, device=dev)
        can = torch.ones((1, n_out), dtype=torch.bool, device=dev)
        prev = torch.zeros((1, n_out), dtype=torch.bool, device=dev)
        paused = torch.empty((1, n_out), dtype=torch.bool, device=dev)
        args += [xoff.data_ptr(), xon.data_ptr(), can.data_ptr(),
                 prev.data_ptr(), out.data_ptr(), paused.data_ptr()]
        n_bytes += n_out * (4 + 4 + 1 + 1 + 1)

        def plain():
            ref.segment_reduce_pfc_ref(vals, idx, n_out, C, xoff, xon, can,
                                       prev, boff, C2)
        held = (xoff, xon, can, prev, paused)
    else:
        args += [out.data_ptr()]

        def plain():
            ref.segment_reduce_ref(vals, *kplan)
        held = ()
    fn = ops.kernel_function(name)
    # the same sums by one PyTorch call: index_add_ of every input into
    # its segment (inputs in no segment go to a spare row)
    seg_of = torch.as_tensor(seg_of, device=dev)
    acc = torch.zeros(n_out + 1, device=dev)

    def index_add():
        acc.index_add_(0, seg_of, vals[0])

    def launch():
        if fn(*args, stream) != 0:
            raise RuntimeError(f"{name} launch failed")
    traced[key] = (launch, index_add,
                   (vals, idx, boff, out, seg_of, acc, *held))
    index_add_ms = cuda_ms(index_add)
    return {"ms": cuda_ms(launch), "host_us_per_launch": host_us(launch),
            "plain_ms": cuda_ms(plain, reps=20, inner=5),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None if pfc else index_add_ms,
            "index_add_ms": index_add_ms,
            "shape": f"{strat} n_in={n_in}", "bytes": n_bytes}


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def steps_apart(ta, tb, dt: float):
    """Event times are float32 stamps of (step + 1) * dt: compare them as
    step counts, so a stamp's own rounding is not read as a step."""
    ta = np.where(np.isfinite(ta), ta, 0.0)
    tb = np.where(np.isfinite(tb), tb, 0.0)
    return np.abs(np.rint(np.asarray(ta, np.float64) / dt)
                  - np.rint(np.asarray(tb, np.float64) / dt))


def compare_runs(a, b, dt: float, what: str) -> dict:
    """The port's whole-run tolerances (tests/test_torch_engine.py)."""
    out = {
        "finished_equal": a.finished == b.finished,
        "completion_diff_steps": float(steps_apart(a.completion_time,
                                                   b.completion_time, dt)),
        "t_finish_max_diff_steps": float(np.max(steps_apart(
            a.t_finish, b.t_finish, dt))),
        "t_finish_flows_differing": int(np.sum(steps_apart(
            a.t_finish, b.t_finish, dt) > 0)),
        "delivered_rel_diff": abs(float(a.delivered.sum())
                                  / float(b.delivered.sum()) - 1.0),
        "pause_max_abs_diff": float(np.max(np.abs(a.pause_count
                                                  - b.pause_count))),
    }
    ok = (out["finished_equal"]
          and out["completion_diff_steps"] <= 1
          and out["t_finish_max_diff_steps"] <= 1
          and out["delivered_rel_diff"] <= 1e-4
          and bool(np.all(np.abs(a.pause_count - b.pause_count)
                          <= 1.0 + 1e-3 * np.abs(b.pause_count))))
    if not ok:
        raise AssertionError(f"{what}: kernel and op paths disagree: {out}")
    return out


def run_main(runner, spec, label: str, impl: str) -> tuple:
    import dataclasses
    import torch
    from repro_torch.kernels.engine_step import ops
    cfg = dataclasses.replace(runner.cfg, step_impl=impl)
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = runner.run_spec(spec, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if not r.finished:
        raise AssertionError(f"{label} {spec.policy} ({impl}) did not finish")
    line = {"phase": "main_path", "scenario": label, "policy": spec.policy,
            "step_impl": impl, "n_flows": r.meta["n_flows"],
            "finished": r.finished, "completion_time": r.completion_time,
            "steps_run": r.meta["steps_run"],
            "steps_executed": r.meta["steps_executed"], "wall_s": wall,
            "steps_per_s": r.meta["steps_executed"] / wall,
            "pause_frames": float(r.pause_count.sum()),
            "launches": launches}
    emit(line)
    return r, launches


# ---------------------------------------------------------------------------
# the DCQCN update kernel, and the batched sweeps
# ---------------------------------------------------------------------------

def dcqcn_state(F: int, seed: int, varied: bool, dev) -> tuple:
    """A DCQCN state as ``tests/test_kernels.py:82-85`` draws it (rc
    scaled by U(0.05, 1), alpha U(0.1, 1), ECN U(0, 0.4)), with numpy;
    ``varied`` also spreads the timers, counters and rt so that every
    branch of the update runs.  Returns ``(state, ecn, line)``."""
    import torch
    from repro_torch.core.cc import dcqcn_jitter
    rng = np.random.default_rng(seed)
    line = np.full(F, 25e9, np.float32)
    st = {"rc": line * rng.uniform(0.05, 1.0, F), "rt": line,
          "alpha": rng.uniform(0.1, 1.0, F), "t_cut": np.full(F, -1.0),
          "t_inc": np.zeros(F), "t_alpha": np.zeros(F),
          "inc_count": np.zeros(F)}
    if varied:
        for k in ("t_cut", "t_inc", "t_alpha"):
            st[k] = rng.uniform(0, 2e-3, F)
        st["inc_count"] = rng.integers(0, 15, F)
        st["rt"] = line * rng.uniform(0.05, 1.0, F)
    ecn = rng.uniform(0, 0.4, F) * (rng.random(F) < (0.6 if varied else 1.0))

    def dev_f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    st = {k: dev_f32(v) for k, v in st.items()}
    st["jit"] = dcqcn_jitter(F, dev)
    return st, dev_f32(ecn), dev_f32(line)


def check_cc_update(dev) -> dict:
    """The DCQCN update kernel against its plain version, bit for bit:
    every F of ``CCU_FLOWS``, two state draws, two times, default and
    non-default (x1.3) parameters."""
    import torch
    from repro_torch.core.cc import make_dcqcn
    from repro_torch.kernels.cc_update import ops, ref
    cases = elems = differ = 0
    worst = 0.0
    for F in CCU_FLOWS:
        for seed, varied in ((F, False), (F + 1, True)):
            st, ecn, line = dcqcn_state(F, seed, varied, dev)
            for t in CCU_TIMES:
                for scale in (1.0, 1.3):
                    params = {k: v * scale
                              for k, v in make_dcqcn().params.items()}
                    got = ops.dcqcn_update(st, ecn, line, t, params)
                    want = ref.dcqcn_update_ref(st, ecn, line, t, params)
                    for k in ops.ORDER:
                        differ += int((got[k] != want[k]).sum())
                        worst = max(worst, float((got[k] - want[k]).abs()
                                                 .max()))
                        elems += F
                    cases += 1
    torch.cuda.synchronize()
    line = {"cases": cases, "flows": list(CCU_FLOWS), "times": CCU_TIMES,
            "params": "defaults and x1.3", "states": "reference draw and "
            "varied timers", "elements": elems, "differ": differ,
            "max_abs_err": worst, "tolerance": "bit for bit"}
    if differ:
        raise AssertionError(f"dcqcn_update differs from its plain version: "
                             f"{line}")
    return line


def time_cc_update(dev, traced: dict) -> dict:
    """Kernel (direct C calls, cycling over 8 input sets, 71 MB, so that
    they do not stay in the 50 MB L2) and plain version at F=130,048."""
    import torch
    from repro_torch.kernels.cc_update import ops, ref
    F = CCU_PATH_FLOWS
    fn = ops.kernel_function()
    p = ref.dcqcn_params(None)
    stream = torch.cuda.current_stream().cuda_stream
    sets = []
    for i in range(8):
        st, ecn, line = dcqcn_state(F, 40 + i, True, dev)
        ins = [st[k] for k in ops.ORDER] + [ecn, line]
        outs = [torch.empty_like(ecn) for _ in ops.ORDER[:7]]
        sets.append((ins, outs, [*(x.data_ptr() for x in ins), 2e-3,
                                 *(p[k] for k in ops.PARAM_ORDER), F,
                                 *(o.data_ptr() for o in outs)]))
    turn = [0]

    def launch():
        args = sets[turn[0] % len(sets)][2]
        turn[0] += 1
        if fn(*args, stream) != 0:
            raise RuntimeError("dcqcn_update launch failed")
    st = dict(zip(ops.ORDER, sets[0][0][:8]))
    ecn, line = sets[0][0][8], sets[0][0][9]
    n_bytes = 4 * F * (10 + 7)
    flops = 60 * F
    ms = cuda_ms(launch)
    traced["dcqcn_update"] = (launch, None, sets)
    return {"ms": ms, "host_us_per_launch": host_us(launch),
            "plain_ms": cuda_ms(
                lambda: ref.dcqcn_update_ref(st, ecn, line, 2e-3, None),
                reps=20, inner=5),
            "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                            flops / F32_FLOPS) * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "shape": f"F={F}", "bytes": n_bytes}


def cc_update_path(dev) -> tuple:
    """The entry point ``dcqcn_update`` driven over a DCQCN trajectory of
    ``CCU_PATH_FLOWS`` flows (the 128-GPU all-reduce's count) for
    ``CCU_PATH_STEPS`` steps of ``DT``: each step marks 30% of the flows
    with an ECN fraction up to 0.4, drawn on the card from a seeded
    generator.  The same trajectory through the plain version must end
    bit for bit in the same state.  Returns ``(launches, line)``."""
    import torch
    from repro_torch.kernels.cc_update import ops, ref
    F, n = CCU_PATH_FLOWS, CCU_PATH_STEPS
    st0, _, line = dcqcn_state(F, 21, False, dev)

    def trajectory(update):
        gen = torch.Generator(device=dev).manual_seed(21)
        st = {k: v.clone() for k, v in st0.items()}
        for i in range(n):
            u = torch.rand(F, generator=gen, device=dev)
            ecn = torch.where(u < 0.3, u * (0.4 / 0.3), 0.0)
            st = update(st, ecn, line, (i + 1) * DT, None)
        return st

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = trajectory(ops.dcqcn_update)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["dcqcn_update"]
    want = trajectory(ref.dcqcn_update_ref)
    differ = sum(int((got[k] != want[k]).sum()) for k in ops.ORDER)
    out = {"flows": F, "steps": n, "launches": launches, "wall_s": wall,
           "elements": F * len(ops.ORDER), "differ": differ,
           "mean_rate_of_line": float((got["rc"] / line).mean()),
           "cuts_seen": int((got["t_cut"] > 0).sum())}
    if launches != n or differ:
        raise AssertionError(f"cc_update_path: {out}")
    return launches, out


def batch_fig12(runner, gpu: str) -> dict:
    """Fig 12's fabric sweep at paper scale as one ``run_batch`` of 9
    lanes on the kernel path; lanes 0 and 8 against the port's serial
    kernel-path runs and the JAX reference's.  Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.core import FabricParams
    from repro_torch.kernels.engine_step import ops
    topo, sched, pol = fig12_scenario()
    cfg = dataclasses.replace(runner.cfg, step_impl="cuda")
    pts = fig12_points()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = runner.run_batch(topo, sched, pol, cfg=cfg, stacked_fabric={
        "kmin": pts[:, 0], "kmax": pts[:, 1], "xoff": pts[:, 2]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = batch.meta["steps_executed"]
    if batch.meta["step_impl"] != "cuda" or \
            launches["fused_signals_policy"] != steps:
        raise AssertionError(f"fig12: {launches} launches for {steps} "
                             f"steps on {batch.meta['step_impl']}")
    if not batch.finished.all():
        raise AssertionError(f"fig12: lanes {batch.lane_status()}")
    lanes = [{"lane": i, "kmin": float(pts[i, 0]), "kmax": float(pts[i, 1]),
              "xoff": float(pts[i, 2]),
              "completion_time": float(batch.completion_time[i]),
              "pause_frames": float(batch.pause_count[i].sum()),
              "finished": bool(batch.finished[i]),
              "steps": batch.meta["lane_steps"][i]} for i in range(batch.n)]
    checks, serial_rate = [], []
    for lane in FIG12_CHECK_LANES:
        kmin, kmax, xoff = (float(v) for v in pts[lane])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = runner.run(topo, sched, pol, cfg=cfg, fabric_params=FabricParams(
            kmin=kmin, kmax=kmax, xoff=xoff))
        torch.cuda.synchronize()
        sw = time.perf_counter() - t1
        serial_rate.append(r.meta["steps_executed"] / sw)
        want = FIG12_REFERENCE[lane]
        ct, pf = lanes[lane]["completion_time"], lanes[lane]["pause_frames"]
        row = {"lane": lane, "batch": ct, "serial": r.completion_time,
               "reference": want["completion_time"],
               "diff_steps_serial": float(steps_apart(ct, r.completion_time,
                                                      DT)),
               "diff_steps_reference": float(steps_apart(
                   ct, want["completion_time"], DT)),
               "pause_batch": pf, "pause_serial": float(r.pause_count.sum()),
               "pause_reference": want["pause_frames"],
               "bit_equal_serial": bool(
                   np.array_equal(r.t_finish, batch.t_finish[lane])
                   and np.array_equal(r.pause_count, batch.pause_count[lane])
                   and np.array_equal(r.delivered, batch.delivered[lane])
                   and r.soft_cost == batch.soft_cost[lane]),
               "serial_wall_s": sw,
               "serial_steps_executed": r.meta["steps_executed"]}
        checks.append(row)
        if not row["bit_equal_serial"]:
            raise AssertionError(f"fig12 lane {lane}: off its serial run "
                                 f"{row}")
        for other in (row["pause_serial"], row["pause_reference"]):
            if abs(pf - other) > 1.0 + 1e-3 * abs(other):
                raise AssertionError(f"fig12 lane {lane}: PAUSE {row}")
        if max(row["diff_steps_serial"], row["diff_steps_reference"]) > 2:
            raise AssertionError(f"fig12 lane {lane}: completion {row}")
    emit({"phase": "batch_fig12", "gpu": gpu, "n_flows": sched.n_flows,
          "n_links": topo.n_links, "policy": pol.name,
          "step_impl": batch.meta["step_impl"], "lanes": lanes,
          "best": batch.best(), "steps_run": batch.meta["steps_run"],
          "steps_executed": steps, "wall_s": wall,
          # each lane's own steps (not the no-ops of a lane that halted)
          "lane_steps_per_s": sum(batch.meta["lane_steps"]) / wall,
          "serial_steps_per_s": serial_rate,
          "serial_wall_s": sum(c["serial_wall_s"] for c in checks),
          "launches": launches, "timing": CONTENDED,
          "checks": checks, "tolerance": "2 steps; PAUSE rtol 1e-3 + 1"})
    return launches, batch


def mesh_lanes(runner, fig12_sim, plain, gpu: str) -> dict:
    """Fig 12's 9 lanes (an odd count: one pad lane) on
    ``grid_mesh(2, devices=[cuda:0, cuda:0])``, the kernel path: every
    lane bit-equal to phase 5c's ``mesh=None`` batch ``plain``, the
    engine kernels launched once a step (segment kernels once a plan and
    step) over the two blocks' steps; and ``mesh="auto"`` resolved on this
    host (None with one card).  Returns the kernels' launches."""
    import dataclasses
    import torch
    from repro_torch.common.sharding import grid_mesh, resolve_grid_mesh
    from repro_torch.kernels.engine_step import ops
    topo, sched, pol = fig12_scenario()
    cfg = dataclasses.replace(runner.cfg, step_impl="cuda")
    pts = fig12_points()
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = grid_mesh(2, devices=[card, card])
    sub = runner.share_prep(mesh=mesh)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = sub.run_batch(topo, sched, pol, cfg=cfg, stacked_fabric={
        "kmin": pts[:, 0], "kmax": pts[:, 1], "xoff": pts[:, 2]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = batch.meta["steps_executed"]
    seg, pfc = segment_launches(fig12_sim.plan)
    equal = {k: bool(np.array_equal(np.asarray(getattr(batch, k)),
                                    np.asarray(getattr(plain, k))))
             for k in ("completion_time", "t_finish", "pause_count",
                       "delivered", "soft_cost", "finished", "diverged",
                       "deadlock_step", "storm_step", "extend_exhausted")}
    auto = resolve_grid_mesh("auto")
    line = {"phase": "mesh_lanes", "gpu": gpu, "lanes": batch.n,
            "mesh": [str(d) for d in mesh.devices],
            "mesh_devices": batch.meta["mesh_devices"],
            "chunk_lanes": batch.meta["chunk_lanes"],
            "step_impl": batch.meta["step_impl"], "wall_s": wall,
            "timing": CONTENDED,
            "steps_executed": steps, "lane_steps": batch.meta["lane_steps"],
            "plain_lane_steps": plain.meta["lane_steps"],
            "launches": launches, "bit_equal": equal,
            "auto_mesh": None if auto is None else [str(d) for d in
                                                    auto.devices],
            "cuda_device_count": torch.cuda.device_count(),
            "note": "both mesh positions are this card: the blocks run one "
                    "after the other (a layout check, not a speed-up)"}
    emit(line)
    if not all(equal.values()) or batch.meta["step_impl"] != "cuda" or \
            batch.meta["lane_steps"] != plain.meta["lane_steps"]:
        raise AssertionError(f"mesh_lanes: off the mesh=None batch: {line}")
    if (launches["fused_signals_policy"], launches["segment_reduce"],
            launches["segment_reduce_pfc"]) != (steps, seg * steps,
                                                pfc * steps):
        raise AssertionError(f"mesh_lanes: {launches} launches for {steps} "
                             "executed steps")
    if (auto is None) != (torch.cuda.device_count() < 2):
        raise AssertionError(f"mesh_lanes: mesh='auto' gave {auto} with "
                             f"{torch.cuda.device_count()} devices")
    return launches


def policy_axis(runner, scen: dict, serial, gpu: str) -> None:
    """The 128-GPU 1D all-reduce under pfc, dcqcn and hpcc as one
    policy-axis batch (op path, as the reference runs stacked policies);
    each lane within two steps of ``REFERENCE``, and the dcqcn lane of
    this script's serial kernel-path run (phase 3's, which ``serial()``
    returns once the batch is done: its ``SERIAL_KEYS`` as arrays).  The
    dcqcn lane is also the op-path side of the 128-GPU kernel-vs-op-path
    check, at the port's whole-run tolerances."""
    from types import SimpleNamespace
    import torch
    from repro_torch.core import ScenarioSpec
    from repro_torch.kernels.engine_step import ops
    fab, wl = scen["clos128_1d"]
    topo, sched, _ = ScenarioSpec(fab, wl, "pfc").build()
    axis = ("pfc", "dcqcn", "hpcc")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = runner.run_policy_axis(topo, sched, axis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()) or batch.meta["step_impl"] != "torch":
        raise AssertionError(f"policy_axis: {ops.LAUNCHES} on "
                             f"{batch.meta['step_impl']}")
    d = serial()
    ser_dcqcn = SimpleNamespace(
        finished=bool(d["finished"]),
        completion_time=float(d["completion_time"]),
        **{k: d[k] for k in ("t_finish", "delivered", "pause_count")})
    rows = []
    for i, pol in enumerate(batch.policy_axis):
        ct = float(batch.completion_time[i])
        row = {"policy": pol, "finished": bool(batch.finished[i]),
               "completion_time": ct,
               "reference": REFERENCE[("clos128_1d", pol)],
               "diff_steps_reference": float(steps_apart(
                   ct, REFERENCE[("clos128_1d", pol)], DT)),
               "pause_frames": float(batch.pause_count[i].sum())}
        ser = ser_dcqcn if pol == "dcqcn" else None  # phase 3: dcqcn only
        if ser is not None:
            row.update(serial=ser.completion_time,
                       diff_steps_serial=float(steps_apart(
                           ct, ser.completion_time, DT)),
                       pause_serial=float(ser.pause_count.sum()))
        rows.append(row)
        if not row["finished"] or max(row["diff_steps_reference"],
                                      row.get("diff_steps_serial", 0)) > 2:
            raise AssertionError(f"policy_axis {pol}: {row}")
    emit({"phase": "policy_axis", "gpu": gpu, "scenario": "clos128_1d",
          "n_flows": sched.n_flows, "step_impl": batch.meta["step_impl"],
          "steps_executed": batch.meta["steps_executed"],
          "lane_steps": batch.meta["lane_steps"], "wall_s": wall,
          "lane_steps_per_s": sum(batch.meta["lane_steps"]) / wall,
          "rows": rows, "tolerance_steps": 2, "timing": CONTENDED})
    i = batch.policy_axis.index("dcqcn")
    lane = SimpleNamespace(
        finished=bool(batch.finished[i]),
        completion_time=float(batch.completion_time[i]),
        t_finish=batch.t_finish[i], delivered=batch.delivered[i],
        pause_count=batch.pause_count[i])
    emit({"phase": "kernel_vs_op_path", "scenario": "clos128_1d",
          "policy": "dcqcn", "op_path": "policy_axis lane",
          **compare_runs(ser_dcqcn, lane, DT, "clos128_1d dcqcn")})


# ---------------------------------------------------------------------------
# phases 5e-5i: the lossy fabric and the learned policy
# ---------------------------------------------------------------------------

def fig13_scenario(policy: str) -> tuple:
    """Fig 13's ``(topo, sched, policy)``: 130,048 flows."""
    from repro_torch.core import CollectiveSpec, FabricSpec, ScenarioSpec
    fab = FabricSpec("clos", n_racks=8, nodes_per_rack=2, gpus_per_node=8,
                     oversubscription=2.0)
    topo, sched, pol = ScenarioSpec(fab, CollectiveSpec("1d", FIG13_BYTES),
                                    policy).build()
    if sched.n_flows != FIG13_FLOWS:
        raise AssertionError(f"fig13: {sched.n_flows} flows, expected "
                             f"{FIG13_FLOWS}")
    return topo, sched, pol


def compare_fault_runs(a, b, dt: float, what: str, steps_tol: int = 2) -> dict:
    """Whole-run agreement under faults: completion within ``steps_tol``
    steps, delivered and lost bytes rtol 1e-4, PAUSE frames rtol 1e-3 +
    1, the same status; ``bit_equal`` says whether they agree exactly."""
    lost_a = 0.0 if a.lost is None else float(np.sum(a.lost))
    lost_b = 0.0 if b.lost is None else float(np.sum(b.lost))
    out = {
        "status": [str(a.status), str(b.status)],
        "completion_diff_steps": float(steps_apart(a.completion_time,
                                                   b.completion_time, dt)),
        "delivered_rel_diff": abs(float(a.delivered.sum())
                                  / float(b.delivered.sum()) - 1.0),
        "lost": [lost_a, lost_b],
        "pause_max_abs_diff": float(np.max(np.abs(a.pause_count
                                                  - b.pause_count))),
        "bit_equal": bool(np.array_equal(a.t_finish, b.t_finish)
                          and np.array_equal(a.delivered, b.delivered)
                          and np.array_equal(a.pause_count, b.pause_count)),
    }
    ok = (out["status"][0] == out["status"][1]
          and out["completion_diff_steps"] <= steps_tol
          and out["delivered_rel_diff"] <= 1e-4
          and abs(lost_a - lost_b) <= 1e-4 * abs(lost_b) + 1e-3
          and bool(np.all(np.abs(a.pause_count - b.pause_count)
                          <= 1.0 + 1e-3 * np.abs(b.pause_count))))
    if not ok:
        raise AssertionError(f"{what}: runs disagree: {out}")
    return out


def against_reference(got: dict, want: dict, dt: float, what: str) -> dict:
    """A run's completion, status, PAUSE total and lost bytes against a
    constant of the JAX reference: 2 steps, the same status, PAUSE rtol
    1e-3 + 1, lost rtol 1e-4."""
    row = {"port": got, "reference": want,
           "diff_steps": float(steps_apart(got["completion_time"],
                                           want["completion_time"], dt))}
    bad = row["diff_steps"] > 2 or got["status"] != want["status"]
    if "pause_frames" in want:
        bad |= abs(got["pause_frames"] - want["pause_frames"]) > \
            1.0 + 1e-3 * abs(want["pause_frames"])
    if "lost" in want:
        bad |= abs(got["lost"] - want["lost"]) > 1e-4 * abs(want["lost"])
    if bad:
        raise AssertionError(f"{what}: against the reference: {row}")
    return row


def run_summary(r) -> dict:
    return {"completion_time": r.completion_time, "status": str(r.status),
            "pause_frames": float(r.pause_count.sum()),
            "lost": 0.0 if r.lost is None else float(np.sum(r.lost))}


def timed_run(runner, *args, **kw) -> tuple:
    """``runner.run(*args, **kw)`` -> (Results, wall seconds, launches)."""
    import torch
    from repro_torch.kernels.engine_step import ops
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = runner.run(*args, **kw)
    torch.cuda.synchronize()
    return (r, time.perf_counter() - t0,
            {k: ops.LAUNCHES[k] - before[k] for k in before})


def lossy_step_check(runner) -> dict:
    """Fig 13's 8 lanes under ``mlp``, stacked on the loss lanes, driven
    ``FIG13_STEP_AT`` steps on the kernel path; then one step from that
    state on each path: every leaf within rtol 1e-5 + atol 1e-3 and every
    flag equal (as ``check_batched_step``).  The state carries a nonzero
    loss signal, so the fused kernel's ``mlp`` body runs on a live
    ``loss`` input with the faulty step around it."""
    import torch
    from repro_torch.core import FaultSpec, engine, sweep
    topo, sched, pol = fig13_scenario("mlp")
    sim = runner.simulator(topo, sched, pol)
    lanes = fig13_lanes()
    B = len(lanes["loss_rate"])
    flt = sweep._stack_fault(FaultSpec(pfc_on=0.0), lanes, B)
    fab = sweep._stack_fabric(sim.fabric, None, B)
    cfg = runner.cfg
    steps = {impl: engine._make_step(pol, cfg, sim.plan, sim.pp, None, fab,
                                     impl == "cuda", B, flt)
             for impl in ("cuda", "torch")}
    carry = engine._init_carry(sim.pp, sim.plan, pol, cfg, None, B, True)
    for it in range(FIG13_STEP_AT):
        carry = steps["cuda"](carry, it)
    loss_sig = carry["loss_sig"]
    if not bool((loss_sig > 0).any()):
        raise AssertionError("lossy_step_check: no loss signal after "
                             f"{FIG13_STEP_AT} steps")
    got = dict(carry_leaves(steps["cuda"](
        engine._tree_map(torch.clone, carry), FIG13_STEP_AT)))
    want = dict(carry_leaves(steps["torch"](
        engine._tree_map(torch.clone, carry), FIG13_STEP_AT)))
    torch.cuda.synchronize()
    equal, worst = 0, 0.0
    for k, a in got.items():
        w = want[k]
        if bool(torch.equal(a, w)):
            equal += 1
            continue
        if not a.is_floating_point():
            raise AssertionError(f"lossy_step_check: {k} differs on "
                                 f"{int((a != w).sum())} elements")
        close = torch.isclose(a, w, rtol=1e-5, atol=1e-3)
        if not bool(close.all()):
            raise AssertionError(f"lossy_step_check: {k}: "
                                 f"{int((~close).sum())} values beyond "
                                 "rtol 1e-5 + atol 1e-3")
        fin = torch.isfinite(w)
        worst = max(worst, float((a - w)[fin].abs().max()))
    return {"policy": "mlp", "lanes": B, "flows_padded": sim.plan.n_flows_pad,
            "step": FIG13_STEP_AT, "leaves": len(got),
            "leaves_bit_equal": equal, "max_abs_err": worst,
            "flows_with_loss_signal": int((loss_sig > 0).sum()),
            "max_loss_signal": float(loss_sig.max()),
            "lost_per_lane": carry["lost"].sum(dim=-1).tolist(),
            "tolerance": "rtol 1e-5 + atol 1e-3; flags equal"}


def fault_grid_dcqcn(runner, gpu: str) -> dict:
    """Fig 13's 8 lanes at paper scale as one ``run_batch`` on the kernel
    path: each lane's status, completion (2 steps) and lost bytes (rtol
    1e-4) against the JAX reference's serial run, lane
    ``FIG13_CHECK_LANE`` bit-equal to its
    serial kernel-path run, which is held against its op-path run on the
    card.  Returns the batch's launches."""
    import dataclasses
    import torch
    from repro_torch.core import FaultSpec
    from repro_torch.kernels.engine_step import ops
    topo, sched, pol = fig13_scenario("dcqcn")
    cfg = dataclasses.replace(runner.cfg, step_impl="cuda")
    lanes = fig13_lanes()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = runner.run_batch(topo, sched, pol, cfg=cfg,
                             fault_spec=FaultSpec(pfc_on=0.0),
                             stacked_fault=lanes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = batch.meta["steps_executed"]
    if batch.meta["step_impl"] != "cuda" or \
            launches["fused_signals_policy"] != steps:
        raise AssertionError(f"fault_grid_dcqcn: {launches} launches for "
                             f"{steps} steps on {batch.meta['step_impl']}")
    status = batch.lane_status()
    rows, bad = [], []
    for i in range(batch.n):
        got = {"completion_time": float(batch.completion_time[i]),
               "status": str(status[i]),
               "lost": float(batch.lost[i].sum())}
        want = FIG13_REFERENCE[i]
        row = {"lane": i, **{k: float(v[i]) for k, v in lanes.items()},
               **got, "steps": batch.meta["lane_steps"][i],
               "reference": want,
               "diff_steps_reference": float(steps_apart(
                   got["completion_time"], want["completion_time"], DT))}
        rows.append(row)
        if row["diff_steps_reference"] > 2 or got["status"] != \
                want["status"] or abs(got["lost"] - want["lost"]) > \
                1e-4 * want["lost"]:
            bad.append(i)
    lane = FIG13_CHECK_LANE
    fault = FaultSpec(**fig13_lane_fault(lane))
    ser, ser_wall, _ = timed_run(runner, topo, sched, pol, cfg=cfg,
                                 fault_spec=fault)
    ser_bit = bool(np.array_equal(ser.t_finish, batch.t_finish[lane])
                   and np.array_equal(ser.delivered, batch.delivered[lane])
                   and np.array_equal(ser.pause_count,
                                      batch.pause_count[lane])
                   and np.array_equal(ser.lost, batch.lost[lane]))
    op, op_wall, op_launches = timed_run(
        runner, topo, sched, pol, fault_spec=fault,
        cfg=dataclasses.replace(runner.cfg, step_impl="torch"))
    if any(op_launches.values()):
        raise AssertionError(f"fault_grid_dcqcn: op path launched "
                             f"{op_launches}")
    emit({"phase": "fault_grid_dcqcn", "gpu": gpu, "n_flows": sched.n_flows,
          "policy": pol.name, "base_fault": {"pfc_on": 0.0},
          "step_impl": batch.meta["step_impl"], "lanes": rows,
          "steps_run": batch.meta["steps_run"], "steps_executed": steps,
          "wall_s": wall,
          "lane_steps_per_s": sum(batch.meta["lane_steps"]) / wall,
          "launches": launches,
          "check_lane": lane, "serial_bit_equal": ser_bit,
          "serial_wall_s": ser_wall,
          "serial_steps_per_s": ser.meta["steps_executed"] / ser_wall,
          "kernel_vs_op_path": compare_fault_runs(
              ser, op, DT, "fault_grid_dcqcn lane kernel vs op path"),
          "op_path_wall_s": op_wall, "timing": CONTENDED,
          "tolerance": "2 steps, the status and lost rtol 1e-4 against "
                       "the reference; batch lane bit-equal to its serial "
                       "run"})
    if bad or not ser_bit:
        raise AssertionError(f"fault_grid_dcqcn: lanes {bad} off the "
                             f"reference, serial bit-equal {ser_bit}")
    return launches


def faults_clos32(runner, scen: dict, gpu: str) -> dict:
    """The 32-GPU 2D all-reduce under DCQCN with PFC on, IRN loss 1e-4,
    ECN at half strength and a degradation window: kernel path (all three
    kernels) against the op path and the reference.  Returns the kernel
    run's launches."""
    import dataclasses
    from repro_torch.core import FaultSpec, ScenarioSpec
    fab, wl = scen["clos32_2d"]
    topo, sched, pol = ScenarioSpec(fab, wl, "dcqcn").build()
    fault = FaultSpec(**FAULTS32_FAULT)
    out = {}
    for impl in ("cuda", "torch"):
        out[impl] = timed_run(runner, topo, sched, pol, fault_spec=fault,
                              cfg=dataclasses.replace(runner.cfg,
                                                      step_impl=impl))
    (r_k, wall_k, l_k), (r_t, wall_t, l_t) = out["cuda"], out["torch"]
    if not all(v > 0 for v in l_k.values()) or any(l_t.values()):
        raise AssertionError(f"faults_clos32: launches {l_k} / {l_t}")
    emit({"phase": "faults_clos32", "gpu": gpu, "n_flows": sched.n_flows,
          "policy": "dcqcn", "fault": FAULTS32_FAULT,
          "kernel": {**run_summary(r_k), "wall_s": wall_k,
                     "steps_executed": r_k.meta["steps_executed"],
                     "launches": l_k},
          "op_path_wall_s": wall_t,
          "kernel_vs_op_path": compare_fault_runs(
              r_k, r_t, DT, "faults_clos32 kernel vs op path"),
          "reference": against_reference(run_summary(r_k), FAULTS32_REFERENCE,
                                         DT, "faults_clos32")})
    return l_k


def mlp_clos128(runner, scen: dict, gpu: str) -> dict:
    """``mlp`` on the kernel path: clos128_1d lossless, then Fig 13's
    scenario with ``FaultSpec.lossy_roce(1e-5, "gbn")`` (against the op
    path on the card too), each against the reference.  Returns the
    kernel runs' launches."""
    import dataclasses
    from repro_torch.core import FaultSpec, ScenarioSpec
    kern = dataclasses.replace(runner.cfg, step_impl="cuda")
    fab, wl = scen["clos128_1d"]
    total = {}
    rows = {}
    for name in ("clos128_1d", "fig13_gbn"):
        if name == "clos128_1d":
            topo, sched, pol = ScenarioSpec(fab, wl, "mlp").build()
            fault = None
        else:
            topo, sched, pol = fig13_scenario("mlp")
            fault = FaultSpec.lossy_roce(1e-5, "gbn")
        r, wall, launches = timed_run(runner, topo, sched, pol, cfg=kern,
                                      fault_spec=fault)
        if launches["fused_signals_policy"] != r.meta["steps_executed"]:
            raise AssertionError(f"mlp {name}: {launches} launches for "
                                 f"{r.meta['steps_executed']} steps")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        row = {"n_flows": sched.n_flows, **run_summary(r), "wall_s": wall,
               "steps_executed": r.meta["steps_executed"],
               "steps_per_s": r.meta["steps_executed"] / wall,
               "launches": launches,
               "reference": against_reference(
                   run_summary(r), MLP_REFERENCE[name], DT, f"mlp {name}")}
        if fault is not None:
            op, op_wall, _ = timed_run(
                runner, topo, sched, pol, fault_spec=fault,
                cfg=dataclasses.replace(runner.cfg, step_impl="torch"))
            row["op_path_wall_s"] = op_wall
            row["kernel_vs_op_path"] = compare_fault_runs(
                r, op, DT, f"mlp {name} kernel vs op path")
        rows[name] = row
    emit({"phase": "mlp_clos128", "gpu": gpu, "policy": "mlp", **rows,
          "launches": total, "timing": CONTENDED})
    return total


def mlp_heldout16(gpu: str) -> None:
    """examples/learn_cc.py's held-out 16-way incast: all eight policies
    in one ``run_policy_axis`` (op path), every lane against the
    reference; the ``mlp`` lane against its serial kernel-path run."""
    import dataclasses
    from repro_torch.core import (EngineConfig, FabricSpec, IncastSpec,
                                  ScenarioSpec, SweepRunner, cc)
    from repro_torch.kernels.engine_step import ops
    runner = SweepRunner(EngineConfig(**HELDOUT_CFG), device="cuda")
    topo, sched, _ = ScenarioSpec(
        FabricSpec(family="single", n_racks=1, nodes_per_rack=1,
                   gpus_per_node=HELDOUT_GPUS),
        IncastSpec(HELDOUT_SENDERS, HELDOUT_BYTES), "mlp").build()
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    batch = runner.run_policy_axis(topo, sched, cc.ALL_POLICIES)
    wall = time.perf_counter() - t0
    if ops.LAUNCHES != before or batch.meta["step_impl"] != "torch":
        raise AssertionError("mlp_heldout16: the policy axis launched "
                             "kernels")
    dt = HELDOUT_CFG["dt"]
    status = batch.lane_status()
    rows = []
    for i, pol in enumerate(batch.policy_axis):
        got = {"completion_time": float(batch.completion_time[i]),
               "status": str(status[i]),
               "pause_frames": float(batch.pause_count[i].sum())}
        rows.append({"policy": pol, **against_reference(
            got, HELDOUT_REFERENCE[pol], dt, f"mlp_heldout16 {pol}")})
    i = batch.policy_axis.index("mlp")
    ser, ser_wall, ser_launches = timed_run(
        runner, topo, sched, "mlp",
        cfg=dataclasses.replace(runner.cfg, step_impl="cuda"))
    if ser_launches["fused_signals_policy"] != ser.meta["steps_executed"]:
        raise AssertionError(f"mlp_heldout16: {ser_launches}")
    lane = run_summary(ser)
    lane_bit = bool(np.array_equal(ser.t_finish, batch.t_finish[i])
                    and np.array_equal(ser.delivered, batch.delivered[i]))
    diff = float(steps_apart(ser.completion_time, batch.completion_time[i],
                             dt))
    emit({"phase": "mlp_heldout16", "gpu": gpu, "n_flows": sched.n_flows,
          "policies": list(batch.policy_axis), "wall_s": wall,
          "lane_steps": batch.meta["lane_steps"], "rows": rows,
          "mlp_serial_kernel": {**lane, "wall_s": ser_wall,
                                "diff_steps_lane": diff,
                                "bit_equal_lane": lane_bit},
          "tolerance": "2 steps and the status"})
    if diff > 2:
        raise AssertionError(f"mlp_heldout16: serial mlp {lane} vs lane "
                             f"{batch.completion_time[i]}")


# ---------------------------------------------------------------------------
# phases 5j-5l: gradients through the simulator (op path, autograd)
# ---------------------------------------------------------------------------

def rel_err(got, want) -> float:
    """|got - want| / |want| (|got - want| where want is 0)."""
    got, want = float(got), float(want)
    return abs(got - want) / abs(want) if want else abs(got - want)


def no_kernel_launches(before: dict, what: str) -> int:
    """The gradient path runs the op path: no fused or PFC launch since
    ``before``.  Its backward sums the gathers' gradients in a fixed order
    through ``segment_reduce`` on the card (``engine._scatter_fixed``):
    returns those launches."""
    from repro_torch.kernels.engine_step import ops
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]}
    seg = launched.pop("segment_reduce", 0)
    if launched:
        raise AssertionError(f"{what}: the gradient path launched kernels "
                             f"{launched}")
    return seg


def compare_tune(res, want: dict, what: str) -> dict:
    """An autotune result against the reference's history: the first
    step's population costs within rtol 5e-3 and the descent lowering the
    cost; every step's cost and parameter error is reported.  (The
    reference's compiled, vmapped cost decodes some members' z-space
    values an ulp away from its eager exp, the history's and the port's
    value, and an ulp of a start value moves this incast's cost by up to
    2.6e-3, after which the trajectories separate: PERF.md.  Where the
    decoded values agree the histories agree within rtol 1e-5 and 1e-3,
    ``tests/test_torch_autotune.py``.)"""
    if len(res.history) != len(want["history"]):
        raise AssertionError(f"{what}: {len(res.history)} steps, reference "
                             f"{len(want['history'])}")
    cost_err = param_err = 0.0
    for h, w in zip(res.history, want["history"]):
        for a, b in zip([h["cost"]] + h["population_costs"],
                        [w["cost"]] + w["population_costs"]):
            cost_err = max(cost_err, rel_err(a, b))
        for k in w:
            if k not in ("step", "cost", "population_costs", "projected",
                         "nonfinite_members"):
                param_err = max(param_err, rel_err(h[k], w[k]))
    start_err = max(rel_err(a, b) for a, b in zip(
        res.history[0]["population_costs"],
        want["history"][0]["population_costs"]))
    row = {"steps": len(res.history), "baseline_cost": res.baseline_cost,
           "tuned_cost": res.tuned_cost,
           "reference_baseline_cost": want["baseline_cost"],
           "reference_tuned_cost": want["tuned_cost"],
           "start_costs_max_rel_err": start_err,
           "cost_max_rel_err": cost_err, "param_max_rel_err": param_err}
    if start_err > 5e-3 or not res.tuned_cost < res.baseline_cost:
        raise AssertionError(f"{what}: {row} (start costs rtol 5e-3, tuned "
                             "below baseline)")
    return row


def autotune_incast8(gpu: str) -> None:
    """``examples/cc_autotune.py``'s CC and fabric tunings through
    ``autotune_spec`` on the card (one batched value-and-grad a descent
    step, the population on the lane axis), each history against the
    reference's."""
    from repro_torch.core import (EngineConfig, FabricSpec, IncastSpec,
                                  ScenarioSpec, autotune_spec, make_dcqcn)
    from repro_torch.kernels.engine_step import ops
    spec = ScenarioSpec(FabricSpec("single", 1, 1, AUTOTUNE_GPUS),
                        IncastSpec(AUTOTUNE_GPUS - 1, AUTOTUNE_BYTES),
                        make_dcqcn())
    rows = {}
    for run, kw in AUTOTUNE_RUNS.items():
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        res = autotune_spec(spec, cfg=EngineConfig(**AUTOTUNE_CFG), **kw)
        wall = time.perf_counter() - t0
        rows[run] = {"population": kw["population"],
                     "s_per_descent_step": wall / kw["steps"],
                     "segment_reduce_launches": no_kernel_launches(
                         before, f"autotune {run}"),
                     **compare_tune(res, AUTOTUNE_REFERENCE[run],
                                    f"autotune {run}")}
    emit({"phase": "autotune_incast8", "gpu": gpu, "device": "cuda",
          "fused_or_pfc_launches": 0, **rows})


def learn_step(gpu: str) -> None:
    """``LEARN_STEPS`` Adam steps of the ``mlp`` trainer on
    ``curriculum_default()`` (3 tasks, the 3 default fabric corners as
    lanes, remat, seed 0) on the card: each task's cost, the loss and the
    gradient norm of each step and the 40 weights against the
    reference's."""
    import repro_torch.learn.train  # noqa: F401  (the package exports train)
    from repro_torch.kernels.engine_step import ops
    tr = sys.modules["repro_torch.learn.train"]
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    res = tr.train(tr.TrainConfig(steps=LEARN_STEPS, seed=0),
                   engine_cfg=tr.default_engine_cfg())
    wall = time.perf_counter() - t0
    seg = no_kernel_launches(before, "learn_step")
    want = LEARN_REFERENCE
    cost_err = max(max(rel_err(h["loss"], w["loss"]), *(
        rel_err(h["per_task"][k], v) for k, v in w["per_task"].items()))
        for h, w in zip(res.history, want["history"]))
    grad_err = max(rel_err(h["grad_norm"], w["grad_norm"])
                   for h, w in zip(res.history, want["history"]))
    weight_err = max(rel_err(res.weights[k], v)
                     for k, v in want["weights"].items())
    row = {"steps": len(res.history), "s_per_adam_step": wall / LEARN_STEPS,
           "losses": [h["loss"] for h in res.history],
           "per_task": [h["per_task"] for h in res.history],
           "cost_max_rel_err": cost_err, "grad_norm_max_rel_err": grad_err,
           "weight_max_rel_err": weight_err}
    emit({"phase": "learn_step", "gpu": gpu, "device": "cuda",
          "fused_or_pfc_launches": 0, "segment_reduce_launches": seg, **row,
          "tolerance": "costs rtol 1e-5, weights and grad norms rtol 1e-3"})
    if (len(res.history) != len(want["history"]) or cost_err > 1e-5
            or weight_err > 1e-3 or grad_err > 1e-3):
        raise AssertionError(f"learn_step: {row}")


def soft_grad_run(sim, remat: bool) -> tuple:
    """The soft cost and its gradient w.r.t. ``SOFT_GRAD_KEYS`` on the
    card: ``(value, grads, forward s, backward s, peak bytes above the
    start)``."""
    import torch
    from repro_torch.core import FabricParams
    cc_keys = [k for k in SOFT_GRAD_KEYS if not k.startswith("fabric.")]
    fab_keys = [k.split(".")[1] for k in SOFT_GRAD_KEYS
                if k.startswith("fabric.")]
    leaves = {k: torch.tensor(np.float32(sim.policy.params[k]),
                              device="cuda", requires_grad=True)
              for k in cc_keys}
    fleaves = {k: torch.tensor(np.float32(getattr(sim.fabric, k)),
                               device="cuda", requires_grad=True)
               for k in fab_keys}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v = sim.soft_cost_fn(remat=remat)(leaves, sim.fabric.replace(**fleaves))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g = torch.autograd.grad(v, [*leaves.values(), *fleaves.values()],
                            allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = dict(zip(SOFT_GRAD_KEYS, (float(x) for x in g)))
    return (float(v.detach()), grads, t1 - t0, t2 - t1,
            torch.cuda.max_memory_allocated() - base)


def backward_plans(sim) -> int:
    """The most fixed-order backward sums a step can take on the card
    (``engine._scatter_fixed``, one ``segment_reduce`` launch each): the
    delayed signals' two gathers (one delay-class plan each) and each
    non-empty hop's share.  A gather whose output the soft cost never
    reads has no backward (DCQCN reads no delayed transmit rate), nor has
    one whose input does not depend on the parameters yet (the ring
    before its first write): ``engine.BACKWARD_SUMS`` counts those that
    ran."""
    return 2 + sum(s[0] != "empty" for s in sim.plan.hop)


GRAD_WINDOW = (300, 64, 16)     # warm steps, timed steps, traced steps
GRAD_PR19 = {"bwd_device_busy_us_per_step": 820.8,
             "bwd_host_ms_per_step": 5.846}    # PERF.md §5, before the fixed order


def grad_window(sim) -> dict:
    """The differentiable step's backward over a window, as
    ``scripts/profile_step.py``'s ``clos128_grad`` measures it (beside
    ``GRAD_PR19``, the ``index_add_`` backward's): warmed ``GRAD_WINDOW[0]`` steps without
    autograd, then ``GRAD_WINDOW[1]`` steps recorded under autograd and
    differentiated w.r.t. ``rai_frac`` and ``g`` (host ms a step) twice
    over the same graph, the two gradients bit for bit (the backward
    repeated at full scale), then ``GRAD_WINDOW[2]`` more, the backward
    under ``torch.profiler`` (device kernels, busy µs and
    ``segment_reduce`` launches a step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import engine
    cfg = dataclasses.replace(sim.cfg, step_impl="torch", queue_stride=0)
    leaves = {k: torch.tensor(np.float32(sim.policy.params[k]),
                              device="cuda", requires_grad=True)
              for k in ("rai_frac", "g")}
    step = engine._make_step(sim.policy, cfg, sim.plan, sim.pp, leaves,
                             sim.fabric, False, 1, None, grad=True)
    carry = engine._init_carry(sim.pp, sim.plan, sim.policy, cfg, leaves, 1,
                               False)
    warm, n_timed, n_traced = GRAD_WINDOW
    it = 0
    with torch.no_grad():
        for it in range(warm):
            carry = step(carry, it)
    it = warm

    def window(n):
        nonlocal carry, it
        carry = engine._tree_map(lambda t: t.detach(), carry)
        for _ in range(n):
            carry = step(carry, it)
            it += 1
        torch.cuda.synchronize()

        def backward():
            g = torch.autograd.grad(carry["soft"].sum(),
                                    list(leaves.values()), retain_graph=True)
            torch.cuda.synchronize()
            return [float(x) for x in g]
        return backward
    backward = window(n_timed)
    t0 = time.perf_counter()
    first = backward()
    host_ms = (time.perf_counter() - t0) / n_timed * 1e3
    again = backward()
    backward = window(n_traced)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backward()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    seg = sum("segment_" in e.name for e in dev)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev)
    return {"first_timed_step": warm, "timed_steps": n_timed,
            "traced_steps": n_traced, "grad": first, "grad_again": again,
            "grad_bit_equal": first == again,
            "bwd_host_ms_per_step": host_ms,
            "bwd_device_busy_us_per_step": busy / n_traced if dev else None,
            "bwd_device_kernels_per_step": len(dev) / n_traced,
            "bwd_segment_kernels_per_step": seg / n_traced,
            "pr19": GRAD_PR19}


SOFT_GRAD_RUNS = (("clos32_2d", False, None),
                  ("clos128_1d", True, SOFT_GRAD_CHUNK))


def soft_grad(runner, scen: dict, forward, gpu: str, labels: tuple,
              phase: str) -> None:
    """The soft cost and its gradient through autograd on the op path:
    at 32 GPUs against the reference's value (bit for bit) and gradient,
    at the paper's 128 GPUs (``remat``, ``SOFT_GRAD_CHUNK`` steps a
    segment) with a finite gradient; each value bit-equal to the forward
    runs' ``Results.soft_cost`` of phases 3-4, which ``forward()``
    returns (scenario -> soft cost and executed steps).  The ``repeat``
    runs are repeated in this process and must give the same gradient bit
    for bit; at 128 GPUs (190-330 s a run) the backward repeats over
    ``grad_window``'s 64 steps of the same graph, bit for bit, and
    ``grad_window`` times it a step beside ``GRAD_PR19``.  The backward sums
    the gathers' gradients in a fixed order (``engine._scatter_fixed``),
    one ``segment_reduce`` launch a sum and no other kernel.
    ``step_impl="cuda"`` refuses it.  Runs the ``SOFT_GRAD_RUNS`` of
    ``labels`` and prints them as ``phase`` (the 32-GPU and 128-GPU runs
    are two child phases, ``soft_grad`` and ``soft_grad128``)."""
    from repro_torch.core import ScenarioSpec, engine
    from repro_torch.kernels.engine_step import ops
    rows, repeats = {}, {}
    for label, remat, chunk in SOFT_GRAD_RUNS:
        if label not in labels:
            continue
        fab, wl = scen[label]
        cfg = runner.cfg if chunk is None else dataclasses.replace(
            runner.cfg, chunk_steps=chunk)
        sim = runner.simulator(*ScenarioSpec(fab, wl, "dcqcn").build(), cfg)
        before = dict(ops.LAUNCHES)
        sums0 = engine.BACKWARD_SUMS["fixed_order"]
        v, grads, fwd_s, bwd_s, peak = soft_grad_run(sim, remat)
        seg = no_kernel_launches(before, f"soft_grad {label}")
        rows[label] = {"remat": remat, "chunk_steps": chunk,
                       "soft_cost": v, "grad": grads,
                       "seconds": fwd_s + bwd_s, "fwd_s": fwd_s,
                       "bwd_s": bwd_s, "peak_bytes": peak,
                       "backward_plans": backward_plans(sim),
                       "backward_sums": engine.BACKWARD_SUMS["fixed_order"]
                       - sums0,
                       "segment_reduce_launches": seg}
        if label == "clos32_2d":
            # the same run again in this process: the backward must repeat
            before = dict(ops.LAUNCHES)
            sums0 = engine.BACKWARD_SUMS["fixed_order"]
            v2, grads2 = soft_grad_run(sim, remat)[:2]
            seg2 = no_kernel_launches(before, f"soft_grad {label} again")
            repeats[label] = {
                "soft_cost_equal": v2 == v,
                "grad_bit_equal": all(grads2[k] == grads[k] for k in grads),
                "grad_again": grads2, "segment_reduce_launches": seg2,
                "backward_sums": engine.BACKWARD_SUMS["fixed_order"] - sums0,
                "grad_max_rel_diff": max(rel_err(grads2[k], grads[k])
                                         for k in grads)}
        if label == "clos128_1d":
            rows[label]["backward_window"] = grad_window(sim)
        del sim
    fwd = forward()
    for label, row in rows.items():
        steps = fwd[label]["steps_executed"]
        if "backward_window" in row and not row["backward_window"][
                "grad_bit_equal"]:
            raise AssertionError(f"soft_grad {label}: the backward over the "
                                 "window does not repeat bit for bit: "
                                 f"{row['backward_window']}")
        row.update(steps=steps,
                   fwd_host_ms_per_step=1e3 * row.pop("fwd_s") / steps,
                   bwd_host_ms_per_step=1e3 * row.pop("bwd_s") / steps,
                   forward_run_soft_cost=fwd[label]["soft_cost"])
        rep = repeats.get(label, {"soft_cost_equal": True,
                                  "grad_bit_equal": True,
                                  "backward_sums": row["backward_sums"],
                                  "segment_reduce_launches":
                                      row["segment_reduce_launches"]})
        if label in repeats:
            row["repeat"] = rep
        row["backward_sums_per_step"] = row["backward_sums"] / steps
        if row["soft_cost"] != row["forward_run_soft_cost"] or not all(
                np.isfinite(x) for x in row["grad"].values()):
            raise AssertionError(f"soft_grad {label}: {row}")
        if not (rep["soft_cost_equal"] and rep["grad_bit_equal"]):
            raise AssertionError(f"soft_grad {label}: the gradient does not "
                                 f"repeat bit for bit: {row}")
        if not (0 < row["backward_sums"] == rep["backward_sums"]
                == row["segment_reduce_launches"]
                == rep["segment_reduce_launches"]
                <= row["backward_plans"] * steps):
            raise AssertionError(f"soft_grad {label}: segment_reduce "
                                 f"launches {row['segment_reduce_launches']}, "
                                 f"{rep['segment_reduce_launches']} for "
                                 f"{row['backward_sums']}, "
                                 f"{rep['backward_sums']} backward sums of "
                                 f"at most {row['backward_plans']} a step "
                                 f"over {steps} steps")
        v, grads = row["soft_cost"], row["grad"]
        want = SOFT_GRAD_REFERENCE.get(label)
        if want is not None:
            row["grad_max_rel_err"] = max(rel_err(grads[k], w)
                                          for k, w in want["grad"].items())
            row["reference_soft_cost"] = want["soft_cost"]
            if v != want["soft_cost"] or row["grad_max_rel_err"] > 1e-3:
                raise AssertionError(f"soft_grad {label} vs the reference: "
                                     f"{row}")
    label = labels[0]
    kern = runner.simulator(*ScenarioSpec(*scen[label], "dcqcn").build(),
                            dataclasses.replace(runner.cfg,
                                                step_impl="cuda"))
    try:
        kern.soft_cost_fn()
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("soft_cost_fn ran with step_impl='cuda'")
    emit({"phase": phase, "gpu": gpu, "keys": list(SOFT_GRAD_KEYS),
          "fused_or_pfc_launches": 0,
          "segment_launches": sum(
              r["segment_reduce_launches"]
              + r.get("repeat", {}).get("segment_reduce_launches", 0)
              for r in rows.values()),
          **rows, "cuda_step_impl_refused": refused,
          "tolerance": "soft cost bit-equal; gradient finite, rtol 1e-3 "
                       "of the reference where it is known; each run's "
                       "gradient bit-equal to its repeat; one "
                       "segment_reduce launch a backward sum, at most "
                       "backward_plans a step"})


# the phases run in processes of their own, beside the main process's
# kernel checks and phases 3-5m, all started as soon as the engine
# kernels are built: the three gradient phases (soft_grad's 32-GPU and
# 128-GPU runs apart), the atlas campaign until its SIGKILL, the backend
# calibration (phase 2b), Fig 12's lanes (batch and mesh), the policy
# axis, Fig 13's fault grid and the learned policy at paper scale; the
# ladder and prediction phases (``campaigns``) wait for phase 2b's table
# on disk (their warm start)
CHILD_PHASES = ("learn_step", "soft_grad", "soft_grad128",
                "autotune_incast8", "campaign_atlas128_kill", "calibrate",
                "campaigns", "fig12_lanes", "policy_axis", "fault_grid_dcqcn",
                "mlp_clos128")
# what a child phase's wall seconds were taken beside
CONTENDED = ("wall seconds under contention: in a child process beside the "
             "other child phases and the main process's phases")


def start_child_phases(tmp: Path, names) -> dict:
    """Each child phase of ``names`` in a process of its own
    (``--child-phase NAME TMP``), beside the main process: all of them are
    bound by one host core each, not by the card.  Output goes to files in
    ``tmp``; the children inherit the run's ``REPRO_CACHE_DIR``, where
    phase 2b's child persists its table."""
    procs = {}
    for name in names:
        out = open(tmp / f"{name}.out", "w")
        err = open(tmp / f"{name}.err", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child-phase",
             name, str(tmp)], stdin=subprocess.PIPE, stdout=out, stderr=err,
            text=True), out, err)
    return procs


def send_child(procs: dict, tmp: Path, name: str, line: str) -> None:
    """Hand child phase ``name`` its one line of input from the main
    process (``soft_grad``, ``soft_grad128``: the forward runs' soft
    costs; ``policy_axis``:
    where phase 3's serial run is saved)."""
    stdin = procs[name][0].stdin
    try:
        stdin.write(line + "\n")
        stdin.close()
    except BrokenPipeError:
        finish_child_phases(procs, tmp, (name,))
        raise AssertionError(f"{name} ended before its input") from None


def finish_child_phases(procs: dict, tmp: Path, names) -> dict:
    """Wait for the child phases ``names`` (taking them out of ``procs``),
    print their lines, and fail at the first that failed (the atlas child
    must have died by its own SIGKILL; the others are then stopped).
    Returns each child's JSON lines by phase."""
    lines = {}
    for name in names:
        proc, out, err = procs.pop(name)
        try:
            proc.stdin.close()
        except BrokenPipeError:      # the child ended before its input
            pass
        proc.wait()
        out.close()
        err.close()
        text = (tmp / f"{name}.out").read_text()
        sys.stdout.write(text)
        sys.stdout.flush()
        sys.stderr.writelines(
            f"[{name}] {ln}" for ln in (tmp / f"{name}.err").read_text()
            .splitlines(keepends=True) if ln.startswith("chip_smoke t="))
        for ln in text.splitlines():
            if ln.startswith("{"):
                obj = json.loads(ln)
                lines[obj.get("phase")] = obj
        want = -signal.SIGKILL if name == "campaign_atlas128_kill" else 0
        if proc.returncode != want:
            raise AssertionError(
                f"child phase {name} failed (exit {proc.returncode}, "
                f"expected {want}): "
                + (tmp / f"{name}.err").read_text()[-3000:])
    return lines


def stop_processes(procs: dict) -> None:
    for proc, out, err in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def main_runner():
    """The ``SweepRunner`` of the main paths (phases 3-5h), in the main
    process and in the children that share its scenarios."""
    from repro_torch.core import EngineConfig, SweepRunner
    return SweepRunner(EngineConfig(dt=DT, max_steps=6000, max_extends=6,
                                    queue_stride=0), device="cuda")


def child_phase_main(name: str, tmp: Path) -> int:
    """One child phase in this process (``main`` starts it)."""
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    if name == "autotune_incast8":
        autotune_incast8(gpu)
    elif name == "learn_step":
        learn_step(gpu)
    elif name == "campaign_atlas128_kill":
        campaign_atlas128_kill(tmp / "atlas")
    elif name == "campaigns":
        wait_for_calibration()
        calibrate_warm_start()
        campaign_ladder32(gpu, tmp / "ladder")
        predict32(gpu)
    elif name == "fig12_lanes":
        runner = main_runner()
        _, batch = batch_fig12(runner, gpu)
        mesh_lanes(runner, runner.simulator(*fig12_scenario()), batch, gpu)
    elif name == "policy_axis":
        def serial():
            with np.load(sys.stdin.readline().strip()) as d:
                return {k: d[k] for k in d.files}
        policy_axis(main_runner(), main_scenarios(), serial, gpu)
    elif name == "fault_grid_dcqcn":
        fault_grid_dcqcn(main_runner(), gpu)
    elif name == "mlp_clos128":
        mlp_clos128(main_runner(), main_scenarios(), gpu)
    elif name == "calibrate":
        calibrate(gpu)
    else:
        def forward():
            return json.loads(sys.stdin.readline())
        labels = ("clos128_1d",) if name == "soft_grad128" else ("clos32_2d",)
        soft_grad(main_runner(), main_scenarios(), forward, gpu, labels, name)
    return 0


# ---------------------------------------------------------------------------
# phases 2b, 5m-5p: backend calibration, campaigns, HLO-replay prediction
# ---------------------------------------------------------------------------

def calibrate(gpu: str) -> None:
    """``calibrate_backend(device="cuda")`` with the default probes (90
    and 1,806 flows, B=6), persisted to this run's ``REPRO_CACHE_DIR``:
    the table (``record``) and every probe's serial and batched seconds,
    taken beside the other child phases."""
    from repro_torch.core.sweep import (calibrate_backend,
                                        calibration_cache_path)
    t0 = time.perf_counter()
    cal = calibrate_backend(device="cuda")
    path = calibration_cache_path("cuda")
    if not Path(path).is_file():
        raise AssertionError(f"calibrate: no table persisted at {path}")
    rec = cal.record()
    emit({"phase": "calibrate", "gpu": gpu,
          "seconds": time.perf_counter() - t0, "record": rec,
          "timing": CONTENDED,
          "batching_loses": [p for p in rec["probes"]
                             if p["batched_s"] >= p["serial_s"]]})


def wait_for_calibration(limit_s: float = 900.0) -> None:
    """Wait until phase 2b's child has persisted its table (the write is
    atomic: a temporary file, then a rename)."""
    from repro_torch.core.sweep import calibration_cache_path
    path = Path(calibration_cache_path("cuda"))
    t0 = time.perf_counter()
    while not path.is_file():
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"campaigns: no calibration table at {path} "
                                 f"after {limit_s:.0f} s")
        time.sleep(0.5)


def calibrate_warm_start() -> None:
    """A fresh process's ``get_calibration("cuda")``: phase 2b's measured
    table from disk (``main`` holds it equal to its own)."""
    from repro_torch.core.sweep import get_calibration
    cal = get_calibration("cuda")
    if cal.source != "measured":
        raise AssertionError("calibrate_warm_start: the persisted table "
                             f"was not loaded ({cal})")
    emit({"phase": "calibrate_warm_start", "record": cal.record()})


def atlas_tasks() -> tuple:
    """``benchmarks/atlas.py``'s paper-scale campaign on the port: the
    tasks and their config."""
    from repro_torch.core import (CampaignTask, EngineConfig, FabricSpec,
                                  allreduce_ring, get_policy)
    fab = FabricSpec("clos", n_racks=8, nodes_per_rack=2, gpus_per_node=8,
                     oversubscription=2.0)
    topo = fab.build()
    sched = allreduce_ring(topo, list(range(fab.n_gpus)), ATLAS_BYTES,
                           n_chunks=1)
    tasks = []
    for pol in ATLAS_KEY_PARAM:
        policy = get_policy(pol)
        key, vals, fabric = atlas_lanes(policy)
        tasks.append(CampaignTask(pol, topo, sched, policy,
                                  stacked_params={key: vals},
                                  stacked_fabric=fabric))
    return tasks, EngineConfig(**ATLAS_CFG)


def campaign_atlas128_kill(out: Path) -> None:
    """The atlas campaign in a child that SIGKILLs itself from its
    dispatch hook before its ``ATLAS_KILL_BEFORE``-th chunk, after
    printing what it launched."""
    from repro_torch.core import SweepRunner, run_campaign
    from repro_torch.kernels.engine_step import ops
    tasks, cfg = atlas_tasks()
    calls = {"n": 0, "t0": time.perf_counter()}

    def hook(lo, hi, B):
        calls["n"] += 1
        if calls["n"] == ATLAS_KILL_BEFORE:
            emit({"phase": "campaign_atlas128_kill",
                  "chunks_done": calls["n"] - 1,
                  "seconds": time.perf_counter() - calls["t0"],
                  "launches": dict(ops.LAUNCHES)})
            os.kill(os.getpid(), signal.SIGKILL)

    ops.reset_launches()
    run_campaign(tasks, "atlas_paper_ring128", out_dir=str(out),
                 runner=SweepRunner(cfg, dispatch_hook=hook, device="cuda"),
                 cfg=cfg)
    raise AssertionError("campaign_atlas128_kill: the campaign ended "
                         "without its SIGKILL")


def campaign_atlas128(gpu: str, out: Path, killed: dict) -> dict:
    """Resume the killed atlas campaign from its journal and hold all 48
    cells against the committed CSV.  Returns the engine-kernel launches
    of both processes."""
    import torch
    from repro_torch.core import SweepRunner, run_campaign
    from repro_torch.kernels.engine_step import ops
    tasks, cfg = atlas_tasks()
    rows = atlas_csv()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_campaign(tasks, "atlas_paper_ring128", out_dir=str(out),
                       runner=SweepRunner(cfg, device="cuda"), cfg=cfg,
                       resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    m = res.manifest
    chunks = [c for t in m["tasks"].values() for c in t["chunks"]]
    replayed = sum(c["status"] == "replayed" for c in chunks)
    demotions = {k: t["demotions"] for k, t in m["tasks"].items()
                 if t["demotions"]}
    cells, bad = [], []
    for task in tasks:
        batch = res.results[task.name]
        key = ATLAS_KEY_PARAM[task.name]
        want = [r for r in rows if r["policy"] == task.name]
        status = batch.lane_status()
        if len(want) != batch.n:
            raise AssertionError(f"campaign_atlas128 {task.name}: "
                                 f"{batch.n} lanes, the CSV {len(want)}")
        for i, w in enumerate(want):
            got = {"param_value": float(batch.params[key][i]),
                   **{k: float(batch.fabric[k][i])
                      for k in ("kmin", "kmax", "xoff")},
                   "completion_ms": float(batch.completion_time[i]) * 1e3,
                   "pfc_frames": float(batch.pause_count[i].sum()),
                   "lane_status": str(status[i])}
            d_steps = float(steps_apart(got["completion_ms"] / 1e3,
                                        w["completion_ms"] / 1e3, DT))
            ok = (all(got[k] == w[k] for k in ("param_value", "kmin",
                                               "kmax", "xoff"))
                  and d_steps <= 2
                  and abs(got["pfc_frames"] - w["pfc_frames"])
                  <= 1e-3 * abs(w["pfc_frames"]) + 1
                  and got["lane_status"] == w["lane_status"])
            cell = {"policy": task.name, "lane": i, **got,
                    "csv_completion_ms": w["completion_ms"],
                    "csv_pfc_frames": w["pfc_frames"],
                    "diff_steps": d_steps, "agrees": ok}
            cells.append(cell)
            if not ok:
                bad.append(cell)
    task_s = {k: sum(c.get("wall_s", 0.0) for c in t["chunks"])
              for k, t in m["tasks"].items()}
    total = {k: killed["launches"][k] + launches[k] for k in launches}
    emit({"phase": "campaign_atlas128", "gpu": gpu,
          "status": res.status, "coverage": m["coverage"],
          "replayed": replayed, "demotions": demotions,
          "task_wall_s": task_s, "resume_seconds": wall,
          "killed_after_chunks": killed["chunks_done"],
          "killed_seconds": killed["seconds"],
          "launches_before_kill": killed["launches"],
          "launches_after_resume": launches,
          "cells_agree": len(cells) - len(bad), "cells": len(cells),
          "max_diff_steps": max(c["diff_steps"] for c in cells),
          "disagree": bad,
          "timing": "dcqcn and hpcc " + CONTENDED + "; timely and mlp "
                    "resumed in the main process beside the child phases "
                    "still running",
          "tolerance": "completion within 2 steps, PAUSE rtol 1e-3 + 1, "
                       "lane status equal, lane params equal"})
    if (res.status != "complete" or m["coverage"] != 1.0 or replayed != 2
            or killed["chunks_done"] != ATLAS_KILL_BEFORE - 1 or demotions):
        raise AssertionError(f"campaign_atlas128: status {res.status}, "
                             f"coverage {m['coverage']}, {replayed} chunks "
                             f"replayed, demotions {demotions}")
    if not (killed["launches"]["fused_signals_policy"]
            and launches["fused_signals_policy"]
            and launches["segment_reduce"]
            and launches["segment_reduce_pfc"]):
        raise AssertionError("campaign_atlas128: the chunks did not launch "
                             f"the engine kernels ({killed['launches']}, "
                             f"{launches})")
    if bad:
        raise AssertionError(f"campaign_atlas128: {len(bad)} of "
                             f"{len(cells)} cells disagree with "
                             f"{ATLAS_CSV.name}: {bad[:4]}")
    return total


def campaign_ladder32(gpu: str, out: Path) -> None:
    """Three campaigns of 4 DCQCN lanes on clos32_2d whose dispatch hook
    raises ``torch.OutOfMemoryError`` on the first 1, 2 and 2 attempts,
    the third on a runner whose lanes lie over a mesh of the card twice
    (``LADDER_CASES``): each walks the ladder to the recorded rungs, each
    merged result is bit-equal to one plain kernel-path ``run_batch``, and
    each launches the engine kernels (no rung leaves them)."""
    import torch
    from repro_torch.common.sharding import grid_mesh
    from repro_torch.core import (CampaignTask, EngineConfig, ScenarioSpec,
                                  SweepRunner, run_campaign)
    from repro_torch.kernels.engine_step import ops
    cfg = EngineConfig(dt=DT, max_steps=6000, max_extends=6, queue_stride=0)
    topo, sched, _ = ScenarioSpec(*main_scenarios()["clos32_2d"],
                                  "dcqcn").build()
    rai = np.asarray(LADDER_RAI, np.float32)
    runner = SweepRunner(cfg, device="cuda")
    ops.reset_launches()
    plain = runner.run_batch(topo, sched, "dcqcn", {"rai_frac": rai})
    plain_launches = dict(ops.LAUNCHES)
    card = torch.device("cuda", torch.cuda.current_device())
    rows = {}
    for fails, rungs, on_mesh in LADDER_CASES:
        calls = {"n": 0}

        def hook(lo, hi, B, fails=fails):
            calls["n"] += 1
            if calls["n"] <= fails:
                raise torch.OutOfMemoryError(
                    f"injected OOM {calls['n']} of {fails}")

        task = CampaignTask("dcqcn_rai", topo, sched, "dcqcn",
                            stacked_params={"rai_frac": rai})
        # the plan above, shared
        sub = runner.share_prep(dispatch_hook=hook, mesh=grid_mesh(
            2, devices=[card, card]) if on_mesh else None)
        messages = []
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_campaign([task], f"ladder_{rungs[-1]}", out_dir=str(out),
                           runner=sub, cfg=cfg, backoff_s=0.0,
                           progress=messages.append)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        ts = res.manifest["tasks"]["dcqcn_rai"]
        got = [d["rung"] for d in ts["demotions"]]
        batch = res.results["dcqcn_rai"]
        equal = {k: bool(np.array_equal(
            np.asarray(getattr(batch, k)),
            np.asarray(getattr(plain, k)).astype(
                np.asarray(getattr(batch, k)).dtype)))
            for k in ("completion_time", "t_finish", "pause_count",
                      "delivered", "soft_cost", "finished", "diverged",
                      "deadlock_step", "storm_step", "extend_exhausted")}
        rows[rungs[-1]] = {"fails": fails, "mesh_devices":
                           res.manifest["config"]["mesh_devices"],
                           "demotions": got,
                           "ladder": ts["ladder"],
                           "attempts": ts["chunks"][0]["attempts"],
                           "seconds": time.perf_counter() - t0,
                           "launches": launches, "bit_equal": equal,
                           "progress_demotions": sum(
                               "demoting to" in m for m in messages)}
        if (not res.ok or got != rungs or not all(equal.values())
                or rows[rungs[-1]]["progress_demotions"] != fails):
            raise AssertionError(f"campaign_ladder32 ({fails} failures): "
                                 f"{rows[rungs[-1]]}")
        if not launches["fused_signals_policy"]:
            raise AssertionError(f"campaign_ladder32: the {rungs[-1]} "
                                 f"campaign launched no kernel {launches}")
    total = {k: sum(r["launches"][k] for r in rows.values())
             for k in plain_launches}
    emit({"phase": "campaign_ladder32", "gpu": gpu, "lanes": list(LADDER_RAI),
          "plain_run_batch_launches": plain_launches, "rungs": rows,
          "launches": total, "timing": CONTENDED,
          "tolerance": "every rung's merged arrays bit-equal to the plain "
                       "kernel-path run_batch"})


def predict32(gpu: str) -> None:
    """``predict_policies`` on ``PREDICT_OPS`` over the default 32-GPU
    CLOS, all 8 policies: once as the card's table advises
    (``batched=None``) and once the other way; the reports equal each
    other and each comm_time is within 2 steps of the reference's."""
    import torch
    from repro_torch.core import SweepRunner
    from repro_torch.core.hlo_comm import CollectiveOp
    from repro_torch.core.predict import predict_policies
    from repro_torch.kernels.engine_step import ops
    ops_ = [CollectiveOp(*op) for op in PREDICT_OPS]
    runner = SweepRunner(device="cuda")
    advice = runner.policy_axis_pays_off()
    runs, launches = {}, {k: 0 for k in ops.LAUNCHES}
    # first as the table advises (batched=None), then the other way
    for batched in (None, not advice):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = predict_policies(ops_, PREDICT_MESH, PREDICT_AXES,
                                runner=runner, batched=batched)
        torch.cuda.synchronize()
        ran_batched = advice if batched is None else batched
        runs["batched" if ran_batched else "serial"] = {"seconds": time.perf_counter() - t0,
                      "launches": dict(ops.LAUNCHES),
                      "reports": [vars(r) for r in reps]}
        for k in launches:
            launches[k] += ops.LAUNCHES[k]
    a, b = runs["batched"]["reports"], runs["serial"]["reports"]
    rows, worst = [], 0.0
    for r in a:
        want = PREDICT_REFERENCE[r["policy"]]
        d = float(steps_apart(r["comm_time"], want["comm_time"], PREDICT_DT))
        worst = max(worst, d)
        rows.append({"policy": r["policy"], "comm_time": r["comm_time"],
                     "reference": want["comm_time"], "diff_steps": d,
                     "pauses": r["pauses"], "finished": r["finished"]})
        if d > 2 or abs(r["pauses"] - want["pauses"]) > \
                1e-3 * want["pauses"] + 1 or not r["finished"]:
            raise AssertionError(f"predict32 {r['policy']}: {r} vs the "
                                 f"reference {want}")
    emit({"phase": "predict32", "gpu": gpu, "advice_batched": advice,
          "reports_equal": a == b, "max_diff_steps": worst, "rows": rows,
          **{f"{m}_seconds": v["seconds"] for m, v in runs.items()},
          **{f"{m}_launches": v["launches"] for m, v in runs.items()},
          "launches": launches, "timing": CONTENDED,
          "tolerance": "batched and serial reports equal; comm_time "
                       "within 2 steps, PAUSE rtol 1e-3 + 1 of the "
                       "reference"})
    if a != b:
        raise AssertionError(f"predict32: batched {a} != serial {b}")
    if not runs["serial"]["launches"]["fused_signals_policy"]:
        raise AssertionError("predict32: the serial runs launched no kernel")


def main_scenarios() -> dict:
    """The 128-GPU 1D and 32-GPU 2D all-reduces of phases 3-4."""
    from repro_torch.core import CollectiveSpec, FabricSpec
    return {
        "clos128_1d": (FabricSpec("clos", n_racks=8, nodes_per_rack=2,
                                  gpus_per_node=8, oversubscription=2.0),
                       CollectiveSpec("1d", 128e6)),
        "clos32_2d": (FabricSpec("clos", n_racks=2, nodes_per_rack=2,
                                 gpus_per_node=8, oversubscription=2.0),
                      CollectiveSpec("2d", 128e6)),
    }


# ---------------------------------------------------------------------------
# phases 6-9: the DLRM path
# ---------------------------------------------------------------------------

def dlrm_kernel_check(dev) -> dict:
    """The embedding-bag kernel against its plain version, both wrappers,
    bit for bit, over the widths, pooling factors, table counts and sizes
    and batches of the DLRM path (the largest stack is 16 GB)."""
    import torch
    from repro_torch.common import init as init_mod
    from repro_torch.kernels.embedding_bag import ops, ref
    rng = np.random.default_rng(12)
    n = elements = differing = 0
    worst = 0.0
    for T in (3, 64):
        for R in (1000, 1_000_000):
            for D in (8, 64, 128):
                gen = torch.Generator(device=dev).manual_seed(T + R + D)
                tab = init_mod.make((T, R, D), "normal", torch.bfloat16, gen,
                                    dev)
                offset = torch.arange(T, dtype=torch.int32, device=dev) * R
                for P in (1, 5, 60):
                    for B in (1, 7, 256):
                        idx = torch.as_tensor(rng.integers(
                            0, R, (B, T, P), dtype=np.int32), device=dev)
                        rows = (idx + offset[None, :, None]).view(B * T, P)
                        pairs = [
                            (ops.embedding_bag_stacked(tab, idx),
                             ref.embedding_bag_stacked_ref(tab, idx)),
                            (ops.embedding_bag_rows(tab.view(T * R, D), rows),
                             ref.embedding_bag_rows_ref(tab.view(T * R, D),
                                                        rows))]
                        for got, want in pairs:
                            if got.dtype == torch.bfloat16:
                                bad = got.view(torch.int16) != \
                                    want.view(torch.int16)
                            else:
                                bad = got != want
                            differing += int(bad.sum())
                            elements += got.numel()
                            worst = max(worst, float(
                                (got.float() - want.float()).abs().max()))
                        n += 1
                del tab
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"cases": n, "elements": elements, "differing": differing,
           "max_abs_err": worst, "tolerance": "bit-equal"}
    if differing:
        raise AssertionError(f"embedding_bag: {differing} elements differ "
                             f"from the plain version: {out}")
    return out


def embedding_calls(model, B: int, dev) -> tuple:
    """The embedding-bag kernel's direct launch and ``F.embedding_bag`` on
    the model's Table II tables, for a batch of B samples from
    ``dlrm_batch``: ``(launch, library, tensors they touch, shape)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops
    tables = model.tables.data
    T, R, D = tables.shape
    idx = torch.as_tensor(dlrm_batch(0, 1, B, model.cfg)["sparse_idx"],
                          device=dev)
    P = idx.shape[2]
    NB = B * T
    table2d, ids = tables.view(T * R, D), idx.view(NB, P)
    out = torch.empty((NB, D), dtype=torch.bfloat16, device=dev)
    fn = ops.kernel_function()
    args = ops.kernel_args(table2d, ids, T, R, out)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream) != 0:
            raise RuntimeError("embedding_bag launch failed")
    rows64 = (idx.long() + torch.arange(T, device=dev)[None, :, None] * R
              ).view(NB, P)

    def library():
        F.embedding_bag(rows64, table2d, mode="sum")
    return launch, library, (table2d, idx, out, rows64), (T, R, D, P)


def time_embedding(model, B: int, dev) -> dict:
    """Kernel, plain version and ``F.embedding_bag`` on the model's Table
    II tables, for a batch of B samples from ``dlrm_batch``."""
    from repro_torch.kernels.embedding_bag import ref
    # ``held`` keeps the tensors whose raw pointers the launch passes
    launch, lib_fn, held, (T, R, D, P) = embedding_calls(model, B, dev)
    idx = held[1]
    NB = B * T
    library = cuda_ms(lib_fn, reps=10, inner=5)
    ms = cuda_ms(launch, reps=10, inner=5)
    plain = cuda_ms(lambda: ref.embedding_bag_stacked_ref(model.tables.data,
                                                          idx),
                    reps=5, inner=2)
    # each gathered row, each id and each output element once
    n_bytes = NB * P * D * 2 + NB * P * 4 + NB * D * 2
    flops = NB * P * D                     # the float32 adds
    bound = max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    return {"ms": ms, "host_us_per_launch": host_us(launch),
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library,
            "shape": f"B={B} T={T} P={P} D={D} R={R}", "bytes": n_bytes}


def dlrm_forward(gpu: str, dev, traced: dict) -> tuple:
    """The paper's Table II DLRM (1,000,000 rows a table) built on the card
    and scoring one batch of 256 through the entry points; the kernel path
    against the plain one, and the kernel's times."""
    import dataclasses
    import torch
    from repro_torch.configs import get_model
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import DLRM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model("dlrm", device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    batch = dlrm_batch(0, 0, 256, cfg)
    ops.reset_launches()
    logits = model(batch)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches["embedding_bag_rows"] != 1:
        raise AssertionError(f"dlrm_forward: {launches} embedding-bag "
                             "launches for one forward")
    plain = DLRM(dataclasses.replace(cfg, embedding_impl="torch"),
                 device="cuda", params={
                     "tables": model.tables.data,
                     "bot": {k: v.data for k, v in model.bot.items()},
                     "top": {k: v.data for k, v in model.top.items()}})
    want = plain(batch)
    if tuple(logits.shape) != (256,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"dlrm_forward: logits of shape "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if not torch.equal(logits.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("dlrm_forward: kernel and plain paths give "
                             "different logits")
    dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    fwd_ms = cuda_ms(lambda: model(dev_batch), reps=10, inner=5)
    plain_fwd_ms = cuda_ms(lambda: plain(dev_batch), reps=10, inner=5)
    timing = {B: time_embedding(model, B, dev) for B in (256, 2048)}

    # the device-time trace at the end of the run rebuilds the tables (the
    # same seed) rather than hold their 8.19 GB through the serving phases
    def calls():
        from repro_torch.configs import get_model
        return embedding_calls(get_model("dlrm", device="cuda", seed=0), 256,
                               dev)[:3]
    traced["embedding_bag_rows"] = calls
    emit({"phase": "dlrm_forward", "gpu": gpu, "batch": 256,
          "rows_per_table": cfg.rows_per_table,
          "tables_bytes": model.tables.numel() * 2,
          "logits_equal_plain_path": True,
          "logits_mean": float(logits.float().mean()),
          "launches": launches, "build_s": build_s, "cuda_ms": fwd_ms,
          "plain_path_cuda_ms": plain_fwd_ms,
          "samples_per_s": 256 / (fwd_ms * 1e-3),
          "peak_bytes": peak,
          "embedding_bag": {f"B={B}": t for B, t in timing.items()}})
    del plain, model
    torch.cuda.empty_cache()
    return launches, timing[256]


def dlrm_reference(dev) -> dict:
    """Table II widths with small tables and numpy weights, against the
    JAX reference's logits on the same inputs, under the flags that
    ``dlrm_forward`` runs with (PyTorch's default bf16 reduction flag,
    which the forward overrides itself; TF32 off)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import dlrm_batch
    from repro_torch.models import DLRM, param_shapes
    cfg = dataclasses.replace(get_config("dlrm"),
                              rows_per_table=DLRM_REF_ROWS)
    shapes = param_shapes(cfg)
    tree = dlrm_numpy_params(
        {"tables": shapes["tables"][0],
         **{part: {k: leaf[0] for k, leaf in shapes[part].items()}
            for part in ("bot", "top")}}, DLRM_REF_SEED)
    params = {"tables": torch.from_numpy(tree["tables"].view(np.int16))
              .view(torch.bfloat16).to(dev)}
    for part in ("bot", "top"):
        params[part] = {k: torch.from_numpy(v).to(dev)
                        for k, v in tree[part].items()}
    matmul = torch.backends.cuda.matmul
    if not matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("dlrm_reference: expected PyTorch's default "
                             "allow_bf16_reduced_precision_reduction=True")
    model = DLRM(cfg, device="cuda", params=params)
    got = model(dlrm_batch(DLRM_REF_SEED, 0, DLRM_REF_BATCH, cfg))
    got = got.float().cpu().numpy()
    want = np.asarray(DLRM_REF_LOGITS, np.float32)
    err = np.abs(got - want)
    out = {"batch": len(want), "max_abs_err": float(err.max()),
           "max_rel_err": float(np.max(err / np.abs(want))),
           "elements_equal": int(np.sum(got == want)),
           "tolerance": f"rtol {DLRM_REF_RTOL}, atol {DLRM_REF_ATOL}"}
    if got.shape != want.shape or not np.all(
            err <= DLRM_REF_ATOL + DLRM_REF_RTOL * np.abs(want)):
        raise AssertionError(f"dlrm_reference: logits off the reference: "
                             f"{out}")
    return out


def dlrm_iteration(cfg, gpu: str) -> dict:
    """The DLRM training iteration on the paper's 128-GPU platform under
    PFC and DCQCN (kernel step path), against the reference's constants.
    Returns the engine kernels' launches over the two runs."""
    import torch
    from repro_torch.core import (DLRMCommSpec, FabricSpec, SweepRunner,
                                  build_dlrm_iteration, get_policy,
                                  simulate_dlrm_policies)
    from repro_torch.kernels.engine_step import ops
    fab = FabricSpec("clos", n_racks=8, nodes_per_rack=2, gpus_per_node=8,
                     oversubscription=2.0)
    topo, gpus = fab.build(), list(range(fab.n_gpus))
    comm = DLRMCommSpec(allreduce_algo="2d")
    runner = SweepRunner(cfg, device="cuda")
    t0 = time.perf_counter()
    sched = build_dlrm_iteration(topo, gpus, comm=comm)
    for pol in DLRM_ITER_REFERENCE:      # plans on the card ahead of time
        runner.simulator(topo, sched, get_policy(pol))
    prep_s = time.perf_counter() - t0
    if sched.n_flows != DLRM_ITER_FLOWS:
        raise AssertionError(f"dlrm_iteration: {sched.n_flows} flows, the "
                             f"reference has {DLRM_ITER_FLOWS}")
    total = {k: 0 for k in ops.LAUNCHES}
    rows = []
    for pol, want in DLRM_ITER_REFERENCE.items():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (rep,) = simulate_dlrm_policies(topo, gpus, (pol,), comm=comm,
                                        cfg=cfg, runner=runner,
                                        batched=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        steps = launches["fused_signals_policy"]   # one per executed step
        if steps == 0 or launches["segment_reduce"] == 0:
            raise AssertionError(f"dlrm_iteration {pol}: a kernel of the "
                                 f"step did not run: {launches}")
        for k, v in launches.items():
            total[k] += v
        row = {"policy": pol, "finished": rep.finished,
               "iteration_time": rep.iteration_time,
               "reference": want["iteration_time"],
               "diff_steps": abs(rep.iteration_time
                                 - want["iteration_time"]) / DT,
               "exposed_comm": rep.exposed_comm,
               "exposed_diff_steps": abs(rep.exposed_comm
                                         - want["exposed_comm"]) / DT,
               "pfc_pauses": rep.pfc_pauses,
               "reference_pauses": want["pfc_pauses"],
               "steps_executed": steps, "wall_s": wall,
               "steps_per_s": steps / wall, "launches": launches}
        rows.append(row)
        if not (rep.finished and row["diff_steps"] <= 2
                and row["exposed_diff_steps"] <= 2
                and abs(rep.pfc_pauses - want["pfc_pauses"])
                <= 1 + 1e-3 * want["pfc_pauses"]):
            raise AssertionError(f"dlrm_iteration {pol}: off the reference: "
                                 f"{row}")
    emit({"phase": "dlrm_iteration", "gpu": gpu, "n_flows": sched.n_flows,
          "prep_s": prep_s, "tolerance": "2 steps on the times; PAUSE "
          "rtol 1e-3 + atol 1", "rows": rows})
    return total


# ---------------------------------------------------------------------------
# phases 10-13: the serving path
# ---------------------------------------------------------------------------

def bf16_ulps(a, b):
    """Distance in bf16 ulps between two bf16 tensors (ordered bits)."""
    import torch

    def key(x):
        x = x.view(torch.int16).int()
        return torch.where(x < 0, -(x & 0x7FFF), x)
    return (key(a) - key(b)).abs()


def fd_tolerance(q, k, v, length, want, softcap=None, scales=None):
    """Flash decode's tolerance, per output element: 1e-5 of the
    softmax-weighted sum of |v| (the scale of the terms the output sums;
    over an int8 cache, of |v| times its scale), plus one bf16 ulp of the
    plain version's output ``want`` for bf16.  With a softcap the scores
    pass through ``cap * tanh(s / cap)``, whose float32 tanh on each side
    is within 2 ulps of a value below 1: up to ``cap * 2**-22`` more on
    each score, so as much more of that sum."""
    import torch
    from repro_torch.kernels.flash_decode import ref
    rel = 1e-5 + (0.0 if softcap is None else softcap * 2.0 ** -22)
    if scales is None:
        tol = rel * ref.flash_decode_ref(q.float(), k.float(),
                                         v.float().abs(), length, softcap)
    else:
        tol = rel * ref.flash_decode_quant_ref(q.float(), k, v.abs(),
                                               *scales, length, softcap)
    if want.dtype == torch.bfloat16:
        w = want.float().abs()
        tol = tol + torch.where(w > 0, torch.exp2(torch.floor(torch.log2(w))
                                                  - 7), 0)
    return tol


def fd_compare(q, k, v, length, softcap=None, scales=None) -> dict:
    """The flash-decode kernel against its plain version on one input, and
    the kernel with the default split (``max_length`` S) against the
    kernel split to the lengths: equal.  ``scales``: an int8 cache's
    ``(k_scale, v_scale)`` (the int8 instantiation against
    ``ref.flash_decode_quant_ref``).  Tolerance: float32 within 1e-5 of
    the softmax-weighted sum of |v|; bf16 within 1 bf16 ulp plus that
    (equal or 1 ulp apart unless the output cancels: counted)."""
    import torch
    from repro_torch.kernels.flash_decode import ops, ref
    ks, vs = scales or (None, None)
    got = ops.flash_decode(q, k, v, length, max_length=int(length.max()),
                           softcap=softcap, k_scale=ks, v_scale=vs)
    again = ops.flash_decode(q, k, v, length, softcap=softcap, k_scale=ks,
                             v_scale=vs)
    want = (ref.flash_decode_ref(q, k, v, length, softcap) if scales is None
            else ref.flash_decode_quant_ref(q, k, v, ks, vs, length,
                                            softcap))
    err = (got.float() - want.float()).abs()
    tol = fd_tolerance(q, k, v, length, want, softcap, scales)
    out = {"elements": got.numel(), "max_abs_err": float(err.max()),
           "split_independent": bool(torch.equal(got, again))}
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        out.update(equal=int((ulps == 0).sum()), one_ulp=int((ulps == 1).sum()),
                   beyond_one_ulp=int((ulps > 1).sum()))
    out["ok"] = bool((err <= tol).all()) and out["split_independent"]
    return out


def decode_kernel_check(dev) -> dict:
    """The flash-decode kernel against its plain version over batches 1/3/8,
    cache lengths S of 1/100/2,048/32,768 with lengths 1, CHUNK - 1, CHUNK,
    CHUNK + 1, S - 17 and S (each for every row, and mixed across rows), kv
    heads x group 4 x 8 (TinyLlama) and 2 x 4, head dims 64 and 128 (and
    256 up to S = 2,048), bf16 and float32; K/V as views one element
    into a buffer (not 16-byte aligned: the scalar loads); and
    ``FD_ARCH_SHAPES`` (Gemma-2, Gemma-3, Phi-4-mini) at S = 100 and 4,352,
    two rows, with the softcap and without; and the int8 instantiation
    (``int8_check``)."""
    import torch
    from repro_torch.kernels.flash_decode import ops
    gen = torch.Generator(device=dev).manual_seed(13)
    C = ops.CHUNK
    totals = {"cases": 0, "elements": 0, "equal": 0, "one_ulp": 0,
              "beyond_one_ulp": 0, "max_abs_err": 0.0, "scalar_loads": 0,
              "softcap_cases": 0, "arch_cases": 0, "int8_cases": 0}
    t0 = time.perf_counter()

    def check(q, k, v, what, softcap=None, scales=None):
        B, S = k.shape[:2]
        lens = sorted({n for n in (1, C - 1, C, C + 1, S - 17, S)
                       if 1 <= n <= S})
        vecs = [[n] * B for n in lens]
        if B > 1:
            vecs.append([lens[b % len(lens)] for b in range(B)])
        for vec in vecs:
            length = torch.tensor(vec, dtype=torch.int32, device=dev)
            r = fd_compare(q, k, v, length, softcap, scales)
            if not r["ok"]:
                raise AssertionError(f"flash_decode {what} lengths {vec}: {r}")
            totals["cases"] += 1
            totals["int8_cases"] += scales is not None
            totals["scalar_loads"] += not ops.vector_loads(k, v)
            for key in ("elements", "equal", "one_ulp", "beyond_one_ulp"):
                totals[key] += r.get(key, 0)
            totals["max_abs_err"] = max(totals["max_abs_err"],
                                        r["max_abs_err"])

    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 3, 8):
            for S in (1, 100, 2048, 32768):
                for Hkv, G in ((4, 8), (2, 4)):
                    for D in (64, 128, 256):
                        if D == 256 and S > 2048:
                            continue
                        q = torch.randn((B, Hkv, G, D), generator=gen,
                                        device=dev).to(dtype)
                        k = torch.randn((B, S, Hkv, D), generator=gen,
                                        device=dev).to(dtype)
                        v = torch.randn((B, S, Hkv, D), generator=gen,
                                        device=dev).to(dtype)
                        check(q, k, v, f"{dtype} B={B} S={S} Hkv={Hkv} "
                              f"G={G} D={D}")
                        del q, k, v
        # a sliced cache: K and V one element into a larger buffer
        B, S, Hkv, G, D = 3, 2048, 4, 8, 64
        n = B * S * Hkv * D
        buf = torch.randn((2 * n + 2,), generator=gen, device=dev).to(dtype)
        q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(dtype)
        check(q, buf[1:1 + n].view(B, S, Hkv, D), buf[n + 2:].view(
            B, S, Hkv, D), f"{dtype} unaligned B={B} S={S}")
        del buf, q
        # Gemma-2's (softcap 50), Gemma-3's and Phi-4-mini's decode
        # shapes, each with the softcap and without; the scores scaled up
        # 4x so that the cap bites
        for (Hkv, G, D), cap in FD_ARCH_SHAPES.items():
            for softcap in (cap, None):
                for S in (100, 4352):
                    q = (4 * torch.randn((2, Hkv, G, D), generator=gen,
                                         device=dev)).to(dtype)
                    k = torch.randn((2, S, Hkv, D), generator=gen,
                                    device=dev).to(dtype)
                    v = torch.randn((2, S, Hkv, D), generator=gen,
                                    device=dev).to(dtype)
                    check(q, k, v, f"{dtype} S={S} Hkv={Hkv} G={G} D={D} "
                          f"softcap={softcap}", softcap)
                    totals["softcap_cases" if softcap else "arch_cases"] \
                        += 1
                    del q, k, v
    int8_check(check, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    totals["seconds"] = time.perf_counter() - t0
    totals["tolerance"] = ("float32: 1e-5 x softmax-weighted sum of |v|, "
                           "+ cap x 2^-22 of it with a softcap; bf16: that "
                           "+ 1 bf16 ulp; split-independent")
    return totals


def int8_check(check, gen, dev) -> None:
    """``decode_kernel_check``'s int8 cases through its ``check``: bf16 q
    over int8 K/V (``quantize_kv`` of random bf16 rows) with their scales,
    B 1 and 8, S 100, 2,048 and 32,768 (D = 256 up to 2,048), kv heads x
    group 4 x 8 and 2 x 4, D 64, 128 and 256; a cache one element into an
    int8 buffer (the scalar loads) and one of D = 48 (no 16-byte rows);
    ``FD_ARCH_SHAPES`` at S = 4,352 with the softcap, scores scaled 4x."""
    import torch
    from repro_torch.models.layers import quantize_kv

    def rand(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)

    def run(B, S, Hkv, G, D, what, softcap=None, qscale=1.0, offset=0):
        q = rand((B, Hkv, G, D), qscale)
        k8, ks = quantize_kv(rand((B, S, Hkv, D)))
        v8, vs = quantize_kv(rand((B, S, Hkv, D)))
        if offset:
            n = k8.numel()
            buf = torch.zeros(2 * n + 2 * offset, dtype=torch.int8,
                              device=dev)
            buf[offset:offset + n] = k8.reshape(-1)
            buf[n + 2 * offset:] = v8.reshape(-1)
            k8 = buf[offset:offset + n].view(k8.shape)
            v8 = buf[n + 2 * offset:].view(v8.shape)
        check(q, k8, v8, f"int8 {what}", softcap, (ks, vs))

    for B in (1, 8):
        for S in (100, 2048, 32768):
            for Hkv, G in ((4, 8), (2, 4)):
                for D in (64, 128, 256):
                    if not (D == 256 and S > 2048):
                        run(B, S, Hkv, G, D, f"B={B} S={S} Hkv={Hkv} G={G} "
                            f"D={D}")
    run(3, 2048, 4, 8, 64, "unaligned B=3 S=2048", offset=1)
    run(3, 300, 4, 8, 48, "D=48 B=3 S=300")
    for (Hkv, G, D), cap in FD_ARCH_SHAPES.items():
        run(2, 4352, Hkv, G, D, f"S=4352 Hkv={Hkv} G={G} D={D} softcap={cap}",
            cap, 4.0)


def draw_serving_weights(model, seed: int, dev) -> tuple:
    """``transformer_numpy_params`` for ``model`` (bf16), on the card; and
    the host seconds the draw took."""
    import torch
    from repro_torch.common.pytree import tree_map
    t0 = time.perf_counter()
    shapes = tree_map(lambda d: d.shape, model.param_defs())
    bits = transformer_numpy_params(shapes, seed, bf16=True)
    params = tree_map(lambda a: torch.from_numpy(a.view(np.int16)).view(
        torch.bfloat16).to(dev), bits)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def serve_entry(gpu: str) -> int:
    """``python -m repro_torch.launch.serve``'s defaults, through its entry
    point: TinyLlama-1.1B at full width and depth, seed-0 weights from a
    ``torch.Generator`` on the card, 8 requests of 32 tokens, 8 new tokens
    each, 4 slots.  Decode attention must go through the kernel, once per
    layer per decode step.  Returns the kernel's launches."""
    import torch
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.main([])
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_decode"]
    eng, model, results = out["engine"], out["model"], out["results"]
    cfg = model.cfg
    steps = sum(t["decode_steps"] for t in eng.timings)
    shape = (cfg.n_layers, cfg.d_model, cfg.vocab)
    if shape != (22, 2048, 32000) or eng.decode_impl != "cuda":
        raise AssertionError(f"serve_entry: {shape}, {eng.decode_impl}")
    if steps == 0 or launches != cfg.n_layers * steps:
        raise AssertionError(f"serve_entry: {launches} flash_decode launches "
                             f"for {steps} decode steps of {cfg.n_layers} "
                             "layers")
    if len(results) != 8 or any(
            r.tokens.shape != (8,) or r.tokens.min() < 0
            or r.tokens.max() >= cfg.vocab for r in results):
        raise AssertionError("serve_entry: wrong results "
                             f"{[r.tokens for r in results]}")
    emit({"phase": "serve_entry", "gpu": gpu, "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "requests": len(results),
          "decode_steps": steps, "launches": launches,
          "launches_per_decode_step": launches / steps,
          "timings": eng.timings,
          "tokens_per_s": sum(len(r.tokens) for r in results)
          / sum(t["prefill_s"] + t["decode_s"] for t in eng.timings),
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "tokens_0": results[0].tokens.tolist()})
    del out, eng, model, results
    torch.cuda.empty_cache()
    return launches


class capture_decode_inputs:
    """While active, keeps copies of the flash-decode wrapper's inputs at
    the calls ``want`` (0-based, counted per call in layer order, of
    ``n_layers`` calls a step), their softcaps and, over an int8 cache,
    their scales, then calls it as before."""

    def __init__(self, n_layers: int, want: tuple):
        self.n_layers, self.want, self.calls, self.inputs = \
            n_layers, want, 0, {}
        self.softcap, self.scales = {}, {}

    def __enter__(self):
        from repro_torch.kernels.flash_decode import ops
        self.ops, self.orig = ops, ops.gqa_decode_attention

        def wrapped(q, k, v, length, max_length=None, softcap=None,
                    k_scale=None, v_scale=None):
            layer = self.calls % self.n_layers
            self.calls += 1
            if layer in self.want:
                B, _, Hq, D = q.shape
                Hkv = k.shape[2]
                self.inputs[layer] = (q.reshape(B, Hkv, Hq // Hkv, D).clone(),
                                      k.clone(), v.clone(), length.clone())
                self.softcap[layer] = softcap
                self.scales[layer] = (None if k_scale is None else
                                      (k_scale.clone(), v_scale.clone()))
            return self.orig(q, k, v, length, max_length, softcap, k_scale,
                             v_scale)
        ops.gqa_decode_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.gqa_decode_attention = self.orig


class plain_decode_attention:
    """While active, the model's ``decode_impl="cuda"`` decode attention
    runs the kernel's plain version (``ref.flash_decode_ref``: float32
    scores, softcap, softmax and p.v; ``flash_decode_quant_ref`` over an
    int8 cache) on the card in the kernel's place,
    over the same positions: the yardstick of the kernel inside a model.
    No kernel launches."""

    def __enter__(self):
        from repro_torch.kernels.flash_decode import ops, ref
        self.ops, self.orig = ops, ops.gqa_decode_attention

        def plain(q, k, v, length, max_length=None, softcap=None,
                  k_scale=None, v_scale=None):
            B, _, Hq, D = q.shape
            Hkv = k.shape[2]
            n = k.shape[1] if max_length is None else max_length
            qr = q.reshape(B, Hkv, Hq // Hkv, D)
            if k_scale is None:
                out = ref.flash_decode_ref(qr, k[:, :n], v[:, :n], length,
                                           softcap)
            else:
                out = ref.flash_decode_quant_ref(
                    qr, k[:, :n], v[:, :n], k_scale[:, :n], v_scale[:, :n],
                    length, softcap)
            return out.reshape(B, 1, Hq, D)
        ops.gqa_decode_attention = plain
        return self

    def __exit__(self, *exc):
        self.ops.gqa_decode_attention = self.orig


def time_flash_decode(inputs, traced: dict, int8: bool = False) -> dict:
    """The kernel (direct C calls), its plain version and
    ``F.scaled_dot_product_attention(..., enable_gqa=True)`` on the cache
    sliced to the (common) length, on captured decode inputs ``[(q, k, v,
    length), ...]``.  Cold (``ms``, ``library_ms``): each call takes the
    next of the input sets, the captured layers and copies of them, whose
    live K/V together exceed ``FD_COLD_BYTES`` (``FD_COLD_SETS`` of them,
    twice as many over an int8 cache), as the decode step meets a layer's
    cache after 21 other layers' and the weights; hot (``ms_hot``,
    ``library_ms_hot``): one set over and over, L2-resident.  ``int8``:
    inputs ``(q, k, v, length, k_scale, v_scale)`` of an int8 cache, its
    instantiation and ``ref.flash_decode_quant_ref``; no PyTorch call
    computes attention over an int8 cache with its scales (no library
    time), and the bound counts a byte an element and the scales."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops, ref
    sets = list(inputs)
    while len(sets) < FD_COLD_SETS * (2 if int8 else 1):
        sets.append(tuple(x.clone() for x in inputs[len(sets) % len(inputs)]))
    q, k, v, length = sets[0][:4]
    B, Hkv, G, D = q.shape
    lens = length.tolist()
    L = max(lens)
    item = q.element_size()
    kv_item = k.element_size() + (4 / D if int8 else 0)   # + a scale a row
    n_bytes = int(sum(lens) * Hkv * D * kv_item * 2 + 2 * q.numel() * item
                  + 4 * B)
    if n_bytes * len(sets) <= FD_COLD_BYTES:
        raise AssertionError(f"time_flash_decode: {len(sets)} sets of "
                             f"{n_bytes} live bytes stay in L2")
    splits = ops.n_splits(k.shape[1], L)
    fn = ops.kernel_function()
    stream = torch.cuda.current_stream().cuda_stream
    args, sdpa_in, outs = [], [], []
    for (qi, ki, vi, li, *scales) in sets:
        part_acc, part_ml = ops.scratch(qi, splits)
        out = torch.empty_like(qi)
        outs.append((out, part_acc, part_ml))
        args.append(ops.kernel_args(qi, ki, vi, li, out, splits, part_acc,
                                    part_ml, None, *scales))
        sdpa_in.append((qi.reshape(B, Hkv * G, 1, D),
                        ki[:, :L].transpose(1, 2), vi[:, :L].transpose(1, 2)))
    turn = [0, 0]

    def launch(i=None):
        if i is None:
            i = turn[0] % len(sets)
            turn[0] += 1
        if fn(*args[i], stream) != 0:
            raise RuntimeError("flash_decode launch failed")

    def sdpa(i=None):
        if i is None:
            i = turn[1] % len(sets)
            turn[1] += 1
        return F.scaled_dot_product_attention(*sdpa_in[i], enable_gqa=True)
    ms, ms_hot = cuda_ms(launch), cuda_ms(lambda: launch(0))
    flops = 4 * sum(lens) * Hkv * G * D
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    out = {"ms": ms, "ms_hot": ms_hot,
           "host_us_per_launch": host_us(launch),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "shape": f"B={B} Hkv={Hkv} G={G} D={D} S={k.shape[1]} "
                    f"length={L} splits={splits}" + (" int8" if int8 else ""),
           "bytes": n_bytes, "cold_sets": len(sets),
           "cold_live_bytes": n_bytes * len(sets)}
    if int8:
        traced["flash_decode/int8"] = (launch, None, (sets, outs))
        out["plain_ms"] = cuda_ms(lambda: ref.flash_decode_quant_ref(
            *sets[0][:3], *sets[0][4:], length), reps=10, inner=5)
        out["library_ms"] = None
        return out
    library, library_hot = cuda_ms(sdpa), cuda_ms(lambda: sdpa(0))
    traced["flash_decode"] = (launch, sdpa, (sets, outs))
    plain = cuda_ms(lambda: ref.flash_decode_ref(q, k, v, length), reps=10,
                    inner=5)
    launch(0)
    diff = (sdpa(0).reshape(B, Hkv, G, D).float() - outs[0][0].float())
    return {**out, "plain_ms": plain, "library_ms": library,
            "library_ms_hot": library_hot,
            "library_host_us_per_call": host_us(sdpa),
            "library_max_abs_diff": float(diff.abs().max())}


def serve_long(gpu: str, dev, traced: dict) -> tuple:
    """TinyLlama-1.1B at full width and depth with hashed weights at the
    true fan-in (``card_weights``; numpy's draw took 31 s of host time):
    8 requests of 2,048-token prompts (the blockwise prefill)
    on 8 slots, a 32,768-token cache (``decode_32k``'s length), 64 new
    tokens, decode attention in the kernel; then the kernel path against
    the torch path, teacher-forced on the kernel path's tokens.  Returns
    the kernel's launches, the check of the captured layer inputs against
    the plain version, and the kernel's times on layers 21's and 0's
    (``time_flash_decode``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("tinyllama-1.1b")
    model = Model(cfg, device="cuda")
    params, draw_s = card_weights(model, SERVE_SEED, dev)
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT),
                           dtype=np.int32)
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN, decode_impl="cuda")
    reqs = [Request(i, prompts[i], SERVE_NEW) for i in range(SERVE_SLOTS)]
    eng.run(reqs[:1])                           # warm-up: one short group
    eng.timings.clear()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_decode"]
    peak = torch.cuda.max_memory_allocated()
    (tm,) = eng.timings
    if launches != cfg.n_layers * tm["decode_steps"] or \
            tm["decode_steps"] != SERVE_NEW - 1:
        raise AssertionError(f"serve_long: {launches} launches for "
                             f"{tm['decode_steps']} decode steps")
    toks = np.stack([r.tokens for r in results])          # (8, 64)

    # teacher-forced: both decode paths on the kernel path's tokens
    _, cache_c = model.prefill(params, {"tokens": prompts},
                               max_len=SERVE_MAX_LEN)
    cache_t = {"layers": [{k: {n: t.clone() for n, t in v.items()}
                           for k, v in g.items()} for g in cache_c["layers"]],
               "pos": cache_c["pos"]}
    rel, agree, torch_s = [], 0, 0.0
    cap = capture_decode_inputs(cfg.n_layers, (0, cfg.n_layers - 1))
    for t in range(SERVE_NEW - 1):
        cur = toks[:, t:t + 1]
        if t == SERVE_NEW - 2:
            with cap:
                got, cache_c = model.decode_step(params, cache_c, cur, "cuda")
        else:
            got, cache_c = model.decode_step(params, cache_c, cur, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, cache_t = model.decode_step(params, cache_t, cur, "torch")
        torch.cuda.synchronize()
        torch_s += time.perf_counter() - t0
        rel.append(float((got - want).norm() / want.norm()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"serve_long: non-finite logits at {t}")
    del cache_c, cache_t
    n = SERVE_SLOTS * (SERVE_NEW - 1)
    line = {"phase": "serve_long", "gpu": gpu, "slots": SERVE_SLOTS,
            "prompt": SERVE_PROMPT, "max_len": SERVE_MAX_LEN,
            "new_tokens": SERVE_NEW, "weights_draw_s": draw_s,
            "prefill_ms": tm["prefill_s"] * 1e3,
            "decode_ms_per_step": tm["decode_s"] / tm["decode_steps"] * 1e3,
            "torch_path_decode_ms_per_step": torch_s / (SERVE_NEW - 1) * 1e3,
            "tokens_per_s": SERVE_SLOTS * SERVE_NEW
            / (tm["prefill_s"] + tm["decode_s"]),
            "decode_tokens_per_s": SERVE_SLOTS * tm["decode_steps"]
            / tm["decode_s"],
            "peak_bytes": peak, "launches": launches,
            "teacher_forced_rel_l2_max": max(rel),
            "teacher_forced_rel_l2_mean": sum(rel) / len(rel),
            "greedy_agreement": agree / n,
            "tolerance": f"rel L2 <= {SERVE_REL_L2} per step"}
    emit(line)
    if max(rel) > SERVE_REL_L2:
        raise AssertionError(f"serve_long: kernel path off the torch path: "
                             f"{line}")
    checks = {}
    for layer, (q, k, v, length) in cap.inputs.items():
        r = fd_compare(q, k, v, length)
        if not r["ok"]:
            raise AssertionError(f"flash_decode on layer {layer}'s decode "
                                 f"inputs: {r}")
        checks[f"layer{layer}"] = r
    if len(checks) != 2:
        raise AssertionError(f"captured layers {sorted(cap.inputs)}")
    timing = time_flash_decode([cap.inputs[cfg.n_layers - 1], cap.inputs[0]],
                               traced)
    del model, params, eng, cap
    torch.cuda.empty_cache()
    return launches, checks, timing


def serve_reference(dev) -> dict:
    """TinyLlama at full width, depth cut to ``SERVE_REF_LAYERS`` (so that
    the JAX reference runs on a CPU), numpy weights at the true fan-in:
    4 rows of 32-token prompts, then 8 teacher-forced decode steps through
    the kernel, against the reference's logits at fixed vocabulary ids, its
    log-sum-exp and its top-1 ids."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=SERVE_REF_LAYERS)
    model = Model(cfg, device="cuda")
    params, _ = draw_serving_weights(model, SERVE_REF_SEED, dev)
    toks = serve_reference_tokens(cfg.vocab)
    S = SERVE_REF_PROMPT
    logits, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                  max_len=S + SERVE_REF_STEPS + 8)
    rows = [logits]
    for t in range(S, S + SERVE_REF_STEPS):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          "cuda")
        rows.append(logits)
    got = torch.stack(rows).float().cpu()               # (steps + 1, B, V)
    out = {"layers": SERVE_REF_LAYERS, "rows": toks.shape[0],
           "steps": SERVE_REF_STEPS + 1,
           **compare_reference_logits(got, SERVE_REF)}
    if not out.pop("ok"):
        raise AssertionError(f"serve_reference: off the reference: {out}")
    del model, params, cache
    torch.cuda.empty_cache()
    return out


def time_flash_decode_softcap(dev, traced: dict) -> dict:
    """The kernel's softcap instantiation at ``FD_SOFTCAP_SHAPE`` (Gemma-2's
    decode over a full 4,096-slot ring, 2 rows, cap 50) and the
    instantiation without it on the same inputs, by direct C calls: cold
    (each call on the other of two input sets, 67 MB of K/V each, past the
    50 MB L2) and hot; the plain version with the softcap; the byte bound
    (K and V of both rows read once).  The library yardsticks, on the same
    inputs in the same turns: ``flex_attention`` compiled, with the cap as
    its ``score_mod`` (the softcap row's ``library_ms``), and SDPA, which
    takes no cap, beside the instantiation without it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import flex_attention
    from repro_torch.kernels.flash_decode import ops, ref
    B, Hkv, G, D, L, cap = FD_SOFTCAP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(23)
    sets = []
    for _ in range(2):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, Hkv, G, D), (B, L, Hkv, D),
                                          (B, L, Hkv, D)))
        sets.append((q, k, v, torch.full((B,), L, dtype=torch.int32,
                                         device=dev)))
    splits = ops.n_splits(L, L)
    fn = ops.kernel_function()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for c in (cap, None):
        calls[c] = []
        for q, k, v, length in sets:
            out = torch.empty_like(q)
            acc, ml = ops.scratch(q, splits)
            calls[c].append((ops.kernel_args(q, k, v, length, out, splits,
                                             acc, ml, c), out, acc, ml))
    turn = [0]

    def launch(c, i=None):
        if i is None:
            i = turn[0] % 2
            turn[0] += 1
        if fn(*calls[c][i][0], stream) != 0:
            raise RuntimeError("flash_decode launch failed")
    # the library's layout: (B, H, 1, D) queries over (B, Hkv, L, D) views
    # of the same caches, query head h reading kv head h // G
    lib_in = [(q.reshape(B, Hkv * G, 1, D), k.transpose(1, 2),
               v.transpose(1, 2)) for q, k, v, _ in sets]
    import torch._inductor.config as inductor_config
    inductor_config.compile_threads = 1       # no compile workers left over
    flex = torch.compile(flex_attention, dynamic=False)

    def capped(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)
    lib_turn = [0, 0]

    def library(use_cap: bool, i=None):
        if i is None:
            i = lib_turn[use_cap] % 2
            lib_turn[use_cap] += 1
        if use_cap:
            return flex(*lib_in[i], score_mod=capped, enable_gqa=True,
                        scale=D ** -0.5)
        return F.scaled_dot_product_attention(*lib_in[i], enable_gqa=True,
                                              scale=D ** -0.5)
    flex_call = ("torch.compile(flex_attention), score_mod cap * tanh(s / "
                 "cap)")
    t0 = time.perf_counter()
    try:
        flex_out = library(True, 0)
    except Exception as e:      # the yardstick only: say which call it was
        flex = flex_attention
        flex_call = (f"flex_attention eager, unfused (torch.compile raised "
                     f"{type(e).__name__}: {str(e)[:200]})")
        flex_out = library(True, 0)
    torch.cuda.synchronize()
    flex_compile_s = time.perf_counter() - t0
    launch(cap, 0)
    launch(None, 0)
    torch.cuda.synchronize()
    want = ref.flash_decode_ref(*sets[0], cap)
    err = (calls[cap][0][1].float() - want.float()).abs()
    if not bool((err <= fd_tolerance(*sets[0], want, cap)).all()):
        raise AssertionError(f"flash_decode softcap: off the plain version "
                             f"by {float(err.max())}")
    n_bytes = 2 * B * L * Hkv * D * 2 + 2 * q.numel() * 2 + 4 * B
    flops = 4 * B * L * Hkv * G * D
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    out = {"softcap_ms": cuda_ms(lambda: launch(cap)),
           "softcap_ms_hot": cuda_ms(lambda: launch(cap, 0)),
           "softcap_nocap_ms": cuda_ms(lambda: launch(None)),
           "softcap_nocap_ms_hot": cuda_ms(lambda: launch(None, 0)),
           "softcap_host_us_per_launch": host_us(lambda: launch(cap)),
           "softcap_plain_ms": cuda_ms(lambda: ref.flash_decode_ref(
               *sets[0], cap), reps=10, inner=5),
           "softcap_bound_ms": max(t_bytes, t_ops) * 1e3,
           "softcap_bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "softcap_library_ms": cuda_ms(lambda: library(True)),
           "softcap_library_ms_hot": cuda_ms(lambda: library(True, 0)),
           "softcap_library_host_us_per_call": host_us(
               lambda: library(True)),
           "softcap_library_call": flex_call,
           "softcap_library_compile_s": flex_compile_s,
           "softcap_library_max_abs_diff": float(
               (flex_out.reshape(B, Hkv, G, D).float()
                - want.float()).abs().max()),
           "softcap_nocap_library_ms": cuda_ms(lambda: library(False)),
           "softcap_nocap_library_ms_hot": cuda_ms(
               lambda: library(False, 0)),
           "softcap_max_abs_err": float(err.max()),
           "softcap_bytes": n_bytes,
           "softcap_shape": f"B={B} Hkv={Hkv} G={G} D={D} length={L} "
                            f"splits={splits} cap={cap}"}
    traced["flash_decode/softcap"] = (
        lambda: launch(cap), lambda: launch(None), lambda: library(True),
        lambda: library(False), (sets, calls))
    return out


def card_weights(model, seed: int, dev) -> tuple:
    """``hashed_params`` for ``model`` on the card (true fan-in, bf16);
    and the seconds the draw took."""
    import torch
    from repro_torch.common.pytree import tree_map
    t0 = time.perf_counter()
    params = hashed_params(tree_map(lambda d: d.shape, model.param_defs()),
                           seed, dev)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def arch_config(arch: str, layers: int | None = None,
                block: int | None = None, **over):
    """The port's config of ``arch``, depth cut to ``layers`` where given,
    the blockwise prefill's tiles set to ``block`` where given (a prompt
    of window + 256 tokens is no multiple of the default 512)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        over["n_layers"] = layers
    if block is not None:
        over.update(block_q=block, block_k=block)
    return dataclasses.replace(cfg, **over)


def serve_arch(arch: str, gpu: str, dev, spec: dict | None = None) -> tuple:
    """``SERVE_ARCHS[arch]`` (or ``spec``) through ``ServeEngine`` on the
    card: full width (depth as listed, config overrides ``over``), hashed
    weights at the true fan-in, ``slots`` slots (2 by default), one prompt
    per slot, decode attention in the kernel (one launch per attention
    layer (``KERNEL_MIXERS``) and decode step, ring layers, Zamba2's shared
    block and an int8 cache included); then, teacher-forced on the
    engine's tokens, the kernel path against the same model with the
    kernel's plain version in its place (``plain_decode_attention``) and
    against the torch path (the reference's serving math, which rounds p
    to bf16 before p.v), each per step (from the kernel path's cache of
    that step where ``resync``) at ``SERVE_REL_L2`` scaled by
    sqrt(depth / ``SERVE_REL_L2_DEPTH``) above TinyLlama's depth (depth:
    every sub-layer, the residual adds); and the kernel against its plain
    version on the captured inputs of the last step's attention calls
    ``capture`` (by default the first of each mixer kind), at
    ``fd_compare``'s tolerance.  Returns (the engine's kernel launches,
    the capture, the line)."""
    import torch
    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    spec = spec or SERVE_ARCHS[arch]
    base = spec.get("arch", arch)
    cfg = arch_config(base, spec["layers"], spec["block"],
                      **spec.get("over", {}))
    slots = spec.get("slots", SERVE_ARCH_SLOTS)
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params, draw_s = card_weights(model, SERVE_SEED, dev)
    rng = np.random.default_rng(SERVE_SEED)
    S, new = spec["prompt"], spec["new"]
    prompts = rng.integers(0, cfg.vocab, (slots, S), dtype=np.int32)
    eng = ServeEngine(model, params, batch_slots=slots,
                      max_len=spec["max_len"], decode_impl="cuda")
    reqs = [Request(i, prompts[i], new) for i in range(slots)]
    kinds = [k[0] for g in model.groups for _ in range(g.n) for k in g.kinds]
    attn = [i for i, k in enumerate(kinds) if k in KERNEL_MIXERS]
    ops.reset_launches()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_decode"]
    (tm,) = eng.timings
    if tm["decode_steps"] != new - 1 or \
            launches != len(attn) * tm["decode_steps"]:
        raise AssertionError(f"{spec['phase']}: {launches} launches for "
                             f"{tm['decode_steps']} decode steps of "
                             f"{len(attn)} attention layers")
    toks = np.stack([r.tokens for r in results])
    if toks.shape != (slots, new) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        raise AssertionError(f"{spec['phase']}: tokens {toks}")
    _, cache_c = model.prefill(params, {"tokens": prompts},
                               max_len=spec["max_len"])

    def clone(cache):
        return {"layers": [{k: {n: t.clone() for n, t in v.items()}
                            for k, v in g.items()} for g in cache["layers"]],
                "pos": cache["pos"]}
    cache_p, cache_t = clone(cache_c), clone(cache_c)
    rel, rel_kt, rel_pt, agree, torch_s = [], [], [], 0, 0.0
    bound = SERVE_REL_L2 * max(1.0, math.sqrt(len(kinds)
                                              / SERVE_REL_L2_DEPTH))
    calls = [kinds[i] for i in attn]
    want_calls = spec.get("capture") or tuple(sorted(
        {calls.index(k) for k in set(calls)}))
    cap = capture_decode_inputs(len(attn), want_calls)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())
    for t in range(new - 1):
        cur = toks[:, t:t + 1]
        if spec.get("resync"):
            cache_p, cache_t = clone(cache_c), clone(cache_c)
        if t == new - 2:
            with cap:
                got, cache_c = model.decode_step(params, cache_c, cur,
                                                 "cuda")
        else:
            got, cache_c = model.decode_step(params, cache_c, cur, "cuda")
        with plain_decode_attention():
            plain, cache_p = model.decode_step(params, cache_p, cur, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, cache_t = model.decode_step(params, cache_t, cur, "torch")
        torch.cuda.synchronize()
        torch_s += time.perf_counter() - t0
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{spec['phase']}: non-finite logits at {t}")
        rel.append(rel_l2(got, plain))
        rel_kt.append(rel_l2(got, want))
        rel_pt.append(rel_l2(plain, want))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    layer_checks = {}
    for call, (q, k, v, length) in cap.inputs.items():
        r = fd_compare(q, k, v, length, cap.softcap[call], cap.scales[call])
        layer_checks[f"layer{attn[call]}_{calls[call]}"] = {
            "cache_slots": k.shape[1], "length": int(length.max()),
            "softcap": cap.softcap[call], "int8": cap.scales[call] is not None,
            **r}
        if not r["ok"]:
            raise AssertionError(f"{spec['phase']}: flash_decode on layer "
                                 f"{attn[call]}'s decode inputs: {r}")
    cache_bytes = tree_bytes(model.cache_defs(slots, spec["max_len"])[
        "layers"])
    line = {"phase": spec["phase"], "gpu": gpu, "arch": cfg.name,
            "n_layers": cfg.n_layers,
            "full_depth": get_config(base).n_layers == cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            **{f"{k}_layers": kinds.count(k) for k in sorted(set(kinds))},
            "window": cfg.window, "logit_softcap": cfg.logit_softcap,
            "kv_quant_int8": cfg.kv_quant_int8,
            "block_q": cfg.block_q, "slots": slots, "prompt": S,
            "new_tokens": new, "max_len": spec["max_len"],
            "weight_bytes": tree_bytes(params), "weights_draw_s": draw_s,
            "cache_bytes": cache_bytes,
            "prefill_ms": tm["prefill_s"] * 1e3,
            "decode_ms_per_step": tm["decode_s"] / tm["decode_steps"] * 1e3,
            "torch_path_decode_ms_per_step": torch_s / (new - 1) * 1e3,
            "tokens_per_s": slots * new
            / (tm["prefill_s"] + tm["decode_s"]),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches,
            "launches_per_decode_step": launches / tm["decode_steps"],
            "teacher_forced_rel_l2_max": max(rel),
            "teacher_forced_rel_l2_mean": sum(rel) / len(rel),
            "torch_path_rel_l2_max": max(rel_kt),
            "torch_path_rel_l2_mean": sum(rel_kt) / len(rel_kt),
            "plain_vs_torch_path_rel_l2_max": max(rel_pt),
            "plain_vs_torch_path_rel_l2_mean": sum(rel_pt) / len(rel_pt),
            "greedy_agreement": agree / (slots * (new - 1)),
            "tokens_0": toks[0, :16].tolist(),
            "layer_checks": layer_checks,
            "tolerance": f"kernel path vs its plain version in its place "
                         f"and vs the torch path: rel L2 <= {bound:.4g} per "
                         f"step ({SERVE_REL_L2} x sqrt({len(kinds)} / "
                         f"{SERVE_REL_L2_DEPTH}) above {SERVE_REL_L2_DEPTH} "
                         "layers); each captured layer at fd_compare's"}
    if cfg.kv_quant_int8:
        line["bf16_cache_bytes"] = tree_bytes(Model(
            dataclasses.replace(cfg, kv_quant_int8=False),
            device="cuda").cache_defs(
                slots, spec["max_len"])["layers"])
    emit(line)
    if max(rel) > bound or max(rel_kt) > bound:
        raise AssertionError(f"{spec['phase']}: kernel path off its plain "
                             f"version or the torch path: {line}")
    del model, params, eng, cache_c, cache_p, cache_t
    torch.cuda.empty_cache()
    return launches, cap, line


def serve_int8(gpu: str, dev, traced: dict) -> tuple:
    """``SERVE_INT8`` through ``serve_arch`` (22 launches of the int8
    instantiation a decode step, the kernel path against the torch path's
    ``decode_attention_quant`` and its plain version in its place, the
    captured layers at ``fd_compare``'s tolerance, the cache's bytes: int8
    and scales beside bf16's), then the int8 instantiation's times on the
    captured inputs of layers 21 and 0 (``time_flash_decode``).
    Returns (launches, the captured layers' checks, the timing)."""
    launches, cap, line = serve_arch("tinyllama-1.1b/int8", gpu, dev,
                                     SERVE_INT8)
    inputs = [cap.inputs[c] + cap.scales[c] for c in (21, 0)]
    timing = time_flash_decode(inputs, traced, int8=True)
    checks = line["layer_checks"]
    del cap, inputs
    return launches, checks, timing


def kernel_launch_counts() -> dict:
    """Every kernel wrapper's launch count (the four CUDA sources')."""
    from repro_torch.kernels.cc_update import ops as ccu
    from repro_torch.kernels.embedding_bag import ops as emb
    from repro_torch.kernels.engine_step import ops as es
    from repro_torch.kernels.flash_decode import ops as fd
    return {k: v for mod in (es, ccu, emb, fd) for k, v in mod.LAUNCHES.items()}


class capture_routing:
    """While active, records the top-k experts of every MoE call
    (``moe.moe_apply``): ``calls[i]`` the (tokens, k) expert ids of the
    i-th call, its tokens in the caller's (row-major) order."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.mod, self.calls = moe, []
        self.orig = (moe.moe_apply, moe._router)

        def apply(p, x2d, cfg, mesh=None):
            self.calls.append([])
            out = self.orig[0](p, x2d, cfg, mesh)
            self.calls[-1] = torch.cat(self.calls[-1])
            return out

        def router(w, x, cfg):
            gates, idx = self.orig[1](w, x, cfg)
            self.calls[-1].append(idx.sort(-1).values)
            return gates, idx
        moe.moe_apply, moe._router = apply, router
        return self

    def __exit__(self, *exc):
        self.mod.moe_apply, self.mod._router = self.orig


def routed_alike(first, steps, full, n_moe: int, S: int, B: int):
    """Per (row, position) whether every MoE layer routed that position's
    token to the same experts in the prompt's prefill (``first``), the
    decode steps (``steps``: one list of calls a step) and the
    teacher-forced prefill (``full``): (B, S + len(steps)) bool."""
    import torch
    got = []
    for layer in range(n_moe):
        dec = [st[layer].reshape(B, 1, -1) for st in steps]
        got.append(torch.cat([first[layer].reshape(B, S, -1), *dec], 1))
    n = S + len(steps)
    alike = torch.ones((B, n), dtype=torch.bool, device=got[0].device)
    for layer in range(n_moe):
        want = full[layer].reshape(B, -1, got[layer].shape[-1])[:, :n]
        alike &= (got[layer] == want).all(-1)
    return alike


def mla_absorbed_check(model, params, dev, S: int = 64) -> dict:
    """Layer 0's MLA at full width, float32: the absorbed decode
    (``mla_decode`` over the latent cache) at every position against the
    non-absorbed form (``mla_train``), at ``tests/test_blocks.py``'s
    tolerance (rtol 2e-3, atol 2e-3); inputs 0.5 N(0, 1), 2 rows of
    ``S``."""
    import torch
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import mla as MLA
    cfg = model.cfg
    p = tree_map(lambda t: t[0].float(), params["groups"][0]["l0"]["attn"])
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    x = 0.5 * torch.randn((2, S, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(S, device=dev)[None].expand(2, S)
    y_train = MLA.mla_train(p, x, cfg, pos)
    c, pe = MLA.mla_prefill_cache(p, x, cfg, pos)
    err, ok = 0.0, True
    for t in range(S):
        y = MLA.mla_decode(p, x[:, t:t + 1], cfg, c, pe, length=t)[:, 0]
        d = (y - y_train[:, t]).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= 2e-3 + 2e-3 * y_train[:, t].abs()).all())
    return {"positions": S, "max_abs_err": err, "ok": ok}


def rwkv_chunk_check(model, params, dev) -> dict:
    """RWKV-6's time mix at full width on layer 0's weights: the chunked
    form (``rwkv_chunk``) against the token scan on float32 inputs
    (0.5 N(0, 1), 2 rows of the phase's prompt length), outputs and final
    states at ``tests/test_blocks.py``'s tolerance (``RWKV_CHUNK_TOL``)."""
    import torch
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import rwkv as RWKV
    spec = SERVE_FAMILIES["rwkv6-3b"]
    cfg = model.cfg
    p = tree_map(lambda t: t[0].float(), params["groups"][0]["l0"]["mixer"])
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    x = 0.5 * torch.randn((2, spec["prompt"], cfg.d_model), generator=gen,
                          device=dev)
    scan, s1 = RWKV.rwkv6_time_mix(p, x, dataclasses.replace(
        cfg, rwkv_chunk=0), None)
    chunked, s2 = RWKV.rwkv6_time_mix(p, x, dataclasses.replace(
        cfg, rwkv_chunk=spec["chunk"]), None)
    out = {}
    for name, a, b in (("y", chunked, scan), ("state", s2["S"], s1["S"])):
        err = (a - b).abs()
        out[f"{name}_max_abs_err"] = float(err.max())
        out[f"{name}_ok"] = bool((err <= RWKV_CHUNK_TOL * (1 + b.abs()))
                                 .all())
    return out


def serve_family(arch: str, gpu: str, dev) -> dict:
    """``SERVE_FAMILIES[arch]`` (no kernel on its decode path) through
    ``ServeEngine`` on the card: full width, depth as listed, hashed
    weights at the true fan-in, 2 slots, ``decode_impl="cuda"`` (the same
    torch code as "torch": the reference has no kernel there), no kernel
    launch; then, teacher-forced on the engine's tokens, each decode
    step's logits against one prefill of the prompt and those tokens,
    every position's logits (``prefill(all_logits=True)``), at rel. L2
    ``SERVE_FAMILY_REL_L2``.  RWKV-6 (``chunk``): the prefill again in
    chunks, its last logits held at the serving rule against the scan's,
    and layer 0's time mix at ``rwkv_chunk_check``.  Returns the line."""
    import torch
    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    spec = SERVE_FAMILIES[arch]
    cfg = arch_config(arch, spec["layers"])
    model = Model(cfg, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, draw_s = card_weights(model, SERVE_SEED, dev)
    rng = np.random.default_rng(SERVE_SEED)
    S, new = spec["prompt"], spec["new"]
    prompts = rng.integers(0, cfg.vocab, (SERVE_ARCH_SLOTS, S),
                           dtype=np.int32)
    eng = ServeEngine(model, params, batch_slots=SERVE_ARCH_SLOTS,
                      max_len=spec["max_len"], decode_impl="cuda")
    before = kernel_launch_counts()
    results = eng.run([Request(i, prompts[i], new)
                       for i in range(SERVE_ARCH_SLOTS)])
    torch.cuda.synchronize()
    (tm,) = eng.timings
    toks = np.stack([r.tokens for r in results])
    if tm["decode_steps"] != new - 1 or toks.shape != (SERVE_ARCH_SLOTS,
                                                       new) \
            or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"{spec['phase']} {arch}: {tm}, tokens {toks}")
    full = np.concatenate([prompts, toks[:, :-1]], axis=1)

    n_moe = sum(k[1] == "moe" for g in model.groups for _ in range(g.n)
                for k in g.kinds)

    def teacher_forced(dtype):
        """Each decode step's logits against one prefill's of the prompt
        and the engine's tokens, activations in ``dtype``: (rel L2 a step
        and row, whether every MoE layer routed each earlier token of the
        row alike in both, top-1 agreements, all finite)."""
        model.compute_dtype = dtype
        with capture_routing() as r_first:
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          max_len=spec["max_len"])
        steps, routes = [logits], []
        for t in range(new - 1):
            with capture_routing() as r_step:
                logits, cache = model.decode_step(params, cache,
                                                  toks[:, t:t + 1], "cuda")
            steps.append(logits)
            routes.append(r_step.calls)
        del cache
        with capture_routing() as r_full:
            ref, _ = model.prefill(params, {"tokens": full},
                                   max_len=full.shape[1], all_logits=True)
        model.compute_dtype = torch.bfloat16
        rel = torch.stack([(got - ref[:, S - 1 + t]).norm(dim=-1)
                           / ref[:, S - 1 + t].norm(dim=-1)
                           for t, got in enumerate(steps)])   # (steps, B)
        clean = torch.ones_like(rel, dtype=torch.bool)
        if n_moe:
            alike = routed_alike(r_first.calls, routes, r_full.calls, n_moe,
                                 S, SERVE_ARCH_SLOTS)
            # step t reads positions 0 .. S - 1 + t
            clean = torch.stack([alike[:, :S + t].all(-1)
                                 for t in range(len(steps))])
        agree = sum(int((got.argmax(-1) == ref[:, S - 1 + t].argmax(-1))
                        .sum()) for t, got in enumerate(steps))
        return (rel.cpu(), clean.cpu(), agree,
                all(bool(torch.isfinite(x).all()) for x in steps), steps[0])
    rel_bf16, clean_bf16, agree_bf16, finite, scan_bf16 = teacher_forced(
        torch.bfloat16)
    rel, clean, agree, finite32, scan_f32 = teacher_forced(torch.float32)
    held = rel[clean]
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernel_launch_counts().items()
                if v != before[k]}
    finite = finite and finite32
    kinds = [k for g in model.groups for _ in range(g.n) for k in g.kinds]
    line = {"phase": spec["phase"], "gpu": gpu, "arch": cfg.name,
            "n_layers": cfg.n_layers,
            "full_depth": get_config(arch).n_layers == cfg.n_layers,
            "layer_kinds": {str(k): kinds.count(k) for k in set(kinds)},
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "slots": SERVE_ARCH_SLOTS, "prompt": S, "new_tokens": new,
            "max_len": spec["max_len"], "weight_bytes": tree_bytes(params),
            "weights_draw_s": draw_s,
            "cache_bytes": tree_bytes(model.cache_defs(
                SERVE_ARCH_SLOTS, spec["max_len"])["layers"]),
            "prefill_ms": tm["prefill_s"] * 1e3,
            "decode_ms_per_step": tm["decode_s"] / tm["decode_steps"] * 1e3,
            "tokens_per_s": SERVE_ARCH_SLOTS * new
            / (tm["prefill_s"] + tm["decode_s"]),
            "kernel_launches": launched,
            "teacher_forced_rel_l2_max": float(rel.max()),
            "teacher_forced_rel_l2_mean": float(rel.mean()),
            "teacher_forced_routed_alike": [int(clean.sum()),
                                            clean.numel()],
            "teacher_forced_routed_alike_rel_l2_max": float(held.max())
            if held.numel() else None,
            "greedy_agreement": agree / (SERVE_ARCH_SLOTS * new),
            "bf16_teacher_forced_rel_l2_max": float(rel_bf16.max()),
            "bf16_teacher_forced_rel_l2_mean": float(rel_bf16.mean()),
            "bf16_teacher_forced_routed_alike": [int(clean_bf16.sum()),
                                                 clean_bf16.numel()],
            "bf16_greedy_agreement": agree_bf16 / (SERVE_ARCH_SLOTS * new),
            "tokens_0": toks[0, :16].tolist(),
            "tolerance": f"activations in float32: each decode step's "
                         f"logits, row by row, within rel L2 "
                         f"{SERVE_FAMILY_REL_L2} of a teacher-forced "
                         "prefill's wherever every MoE layer routed the "
                         "row's tokens alike in both (at least half the "
                         "steps; a near-tie of the top-k that the bf16 "
                         "latent cache tips is a different computation); "
                         "in bf16 reported, not held; no kernel launches"}
    ok = (finite and not launched and held.numel() >= clean.numel() / 2
          and float(held.max()) <= SERVE_FAMILY_REL_L2)
    if n_moe:
        line["mla_absorbed_check"] = mla_absorbed_check(model, params, dev)
        ok = ok and line["mla_absorbed_check"]["ok"]
    if "chunk" in spec:
        def last_logits(chunk, dtype):
            model.cfg = dataclasses.replace(cfg, rwkv_chunk=chunk)
            model.compute_dtype = dtype
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, _ = model.prefill(params, {"tokens": prompts},
                                   max_len=spec["max_len"])
            torch.cuda.synchronize()
            model.cfg, model.compute_dtype = cfg, torch.bfloat16
            return out, time.perf_counter() - t1
        # the scan's last logits: the teacher-forced runs' first prefill
        chunk_bf16, chunk_s = last_logits(spec["chunk"], torch.bfloat16)
        chunk_f32, _ = last_logits(spec["chunk"], torch.float32)
        err = (chunk_f32 - scan_f32).abs()
        line["chunked_prefill"] = {
            "rwkv_chunk": spec["chunk"], "prefill_ms": chunk_s * 1e3,
            "bf16_last_logits_rel_l2": float((chunk_bf16 - scan_bf16).norm()
                                             / scan_bf16.norm()),
            "f32_last_logits_max_abs_err": float(err.max()),
            "f32_ok": bool((err <= RWKV_CHUNK_TOL
                            * (1 + scan_f32.abs())).all()),
            **rwkv_chunk_check(model, params, dev)}
        c = line["chunked_prefill"]
        ok = ok and c["f32_ok"] and c["y_ok"] and c["state_ok"]
    line["peak_bytes"] = torch.cuda.max_memory_allocated()
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not ok:
        raise AssertionError(f"{spec['phase']} {arch}: {line}")
    del model, params, eng
    torch.cuda.empty_cache()
    return line


def serve_families_reference(name: str, dev) -> tuple:
    """``FAMILIES_REF_CUTS[name]`` on the card with ``hashed_params`` drawn
    there: 4 rows of 32-token prompts, then 8 teacher-forced decode steps
    (``decode_impl="cuda"``: the kernel on the attention layers, its int8
    instantiation on TinyLlama's int8 cache), against the reference's
    logits at ``SERVE_REF_IDS``, its log-sum-exp and its top-1 ids
    (``FAMILIES_REF``, the tolerances of ``serve_reference``); an MoE
    model's only at the (step, row) pairs whose logits came from the
    reference's routing (``routed_like_reference``, its expert ids in the
    record), and on at least half of them.  Returns the line and the
    kernel's launches."""
    import torch
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.models import Model
    arch, layers, over = FAMILIES_REF_CUTS[name]
    cfg = arch_config(arch, layers, **over)
    model = Model(cfg, device="cuda")
    params, _ = card_weights(model, SERVE_REF_SEED, dev)
    toks = serve_reference_tokens(cfg.vocab)
    S = SERVE_REF_PROMPT
    attn = sum(k[0] in KERNEL_MIXERS for g in model.groups for _ in range(g.n)
               for k in g.kinds)
    n_moe = sum(g.n for g in model.groups for k in g.kinds if k[1] == "moe")
    ref = FAMILIES_REF[name]
    ops.reset_launches()
    with capture_routing() as routing:
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                      max_len=S + SERVE_REF_STEPS + 8)
        rows = [logits]
        for t in range(S, S + SERVE_REF_STEPS):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], "cuda")
            rows.append(logits)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_decode"]
    if launches != attn * SERVE_REF_STEPS:
        raise AssertionError(f"families reference {name}: {launches} "
                             f"launches for {attn} attention layers")
    keep = strict = None
    if n_moe:
        keep, strict = routed_like_reference(
            routing.calls, ref["experts"], n_moe, toks.shape[0],
            model.groups[-1].kinds[-1][1] == "moe")
    out = {"name": name, **compare_reference_logits(
        torch.stack(rows).float().cpu(), ref, keep)}
    if strict is not None:
        out["compared_strict"] = [int(strict.sum()), int(strict.size)]
    out.update(layers=cfg.n_layers, vocab=cfg.vocab, rows=toks.shape[0],
               steps=SERVE_REF_STEPS + 1, launches=launches)
    if keep is not None and out["compared"][0] * 2 < out["compared"][1]:
        out["ok"] = False
    if not out.pop("ok"):
        raise AssertionError(f"families reference {name}: off the "
                             f"reference: {out}")
    del model, params, cache
    torch.cuda.empty_cache()
    return out, launches


def sliding_reference_config(arch: str):
    """``arch`` at full width, depth one attention period, the window cut
    to ``SLIDING_REF_WINDOW`` (``SLIDING_REF`` says why): the port's
    config; the reference builds its own from the same fields."""
    from repro_torch.configs import get_config
    return arch_config(arch, len(get_config(arch).attn_pattern),
                       window=SLIDING_REF_WINDOW)


def serve_sliding_reference(arch: str, dev) -> tuple:
    """``sliding_reference_config(arch)`` on the card with ``hashed_params``
    drawn there: 4 rows of 32-token prompts (past the cut window:
    ``local_attention``, the ring filled wrapped), then 8 teacher-forced
    decode steps through the kernel (the ring wraps again), against the
    reference's logits at ``SERVE_REF_IDS``, its log-sum-exp and its top-1
    ids (``SLIDING_REF``, the tolerances of ``serve_reference``).  Returns
    the line and the kernel's launches."""
    import torch
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.models import Model
    cfg = sliding_reference_config(arch)
    model = Model(cfg, device="cuda")
    params, _ = card_weights(model, SERVE_REF_SEED, dev)
    toks = serve_reference_tokens(cfg.vocab)
    S = SERVE_REF_PROMPT
    ops.reset_launches()
    logits, cache = model.prefill(params, {"tokens": toks[:, :S]},
                                  max_len=S + SERVE_REF_STEPS + 8)
    rows = [logits]
    for t in range(S, S + SERVE_REF_STEPS):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          "cuda")
        rows.append(logits)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_decode"]
    if launches != cfg.n_layers * SERVE_REF_STEPS:
        raise AssertionError(f"sliding reference {arch}: {launches} "
                             "launches")
    ref = SLIDING_REF[arch]
    out = {"arch": arch, **compare_reference_logits(
        torch.stack(rows).float().cpu(), ref)}
    out.update(layers=cfg.n_layers, window=cfg.window, vocab=cfg.vocab,
               rows=toks.shape[0], steps=SERVE_REF_STEPS + 1,
               ring_slots=cache["layers"][0]["l0"]["k"].shape[2],
               launches=launches)
    if not out.pop("ok"):
        raise AssertionError(f"sliding reference {arch}: off the "
                             f"reference: {out}")
    del model, params, cache
    torch.cuda.empty_cache()
    return out, launches


def logit_scale(ref: dict) -> float:
    """The root mean square of a reference record's logits at the ids."""
    return float(np.sqrt(np.mean(np.square(np.asarray(ref["logits"],
                                                        np.float64)))))


def routed_like_reference(calls, want, n_moe: int, B: int,
                          last_is_final: bool) -> tuple:
    """Whether a (step, row)'s logits came from the routing the
    reference's did: every MoE layer routed the tokens those logits
    depend on to the experts the reference picked (``want``: the record's
    ``experts``, one list of (tokens, k) sorted ids a layer a step;
    ``calls``: ``capture_routing``'s, ``n_moe`` a step).  A token's MoE
    output reaches later positions only through the layers after it: an
    MoE layer before the last one counts every token of the row so far,
    and the last, where it is the model's final layer
    (``last_is_final``), only the token whose logits these are (the
    prompt's last one at step 0).  A top-k near-tie that bf16 tips sends
    a token to another expert, and logits that depend on it measure the
    rounding, not the port.  Returns ((steps, rows) bool, the same with
    every token of the row so far in every layer: the strict count)."""
    history = np.ones(B, bool)
    strict = np.ones(B, bool)
    keep, keep_strict = [], []
    for step, layers in enumerate(want):
        own = np.ones(B, bool)
        for layer, ids in enumerate(layers):
            got = calls[step * n_moe + layer].cpu().numpy().reshape(
                B, -1, len(ids[0]))
            same = got == np.asarray(ids).reshape(got.shape)
            strict &= same.all((1, 2))
            if last_is_final and layer == n_moe - 1:
                own &= same[:, -1].all(-1)
            else:
                history &= same.all((1, 2))
        keep.append(history & own)
        keep_strict.append(strict.copy())
    return np.stack(keep), np.stack(keep_strict)


def compare_reference_logits(got, ref: dict, keep=None) -> dict:
    """Logits ``got`` (steps, rows, V) against a reference record
    (``logits`` at ``SERVE_REF_IDS``, ``lse``, ``top1``, ``margin``) at
    ``serve_reference``'s tolerances, the absolute ones (logits at the
    ids, log-sum-exp, near-tie margin) scaled by the record's logit scale
    over ``SERVE_REF``'s (bf16 rounding errors scale with the logits: a
    tied embedding of std 0.02 read out over sqrt(d_model), as the Gemma
    configs do, gives logits about 50x smaller than TinyLlama's head);
    ``ok`` says whether they hold.  ``keep`` (steps, rows) bool limits the
    comparison to those (step, row) pairs (an MoE model's, where it
    routed as the reference did: ``routed_like_reference``); ``compared``
    counts them."""
    import torch
    scale = logit_scale(ref) / logit_scale(SERVE_REF)
    atol, lse_atol = SERVE_REF_ATOL * scale, SERVE_REF_LSE_ATOL * scale
    ids = torch.as_tensor(SERVE_REF_IDS)
    at_ids = got[:, :, ids].numpy()
    want = np.asarray(ref["logits"], np.float32)
    lse = torch.logsumexp(got, -1).numpy()
    top1 = got.argmax(-1).numpy()
    if keep is None:
        keep = np.ones(top1.shape, bool)
    differ = (top1 != np.asarray(ref["top1"])) & keep
    margin = np.asarray(ref["margin"])
    err = np.abs(at_ids - want)[keep]
    lse_err = np.abs(lse - np.asarray(ref["lse"]))[keep]
    out = {"max_abs_err_at_ids": float(err.max()) if err.size else 0.0,
           "rel_l2_at_ids_max": float(max(
               (np.linalg.norm(at_ids[s][keep[s]] - want[s][keep[s]])
                / np.linalg.norm(want[s][keep[s]])
                for s in range(len(want)) if keep[s].any()), default=0.0)),
           "lse_max_abs_err": float(lse_err.max()) if lse_err.size else 0.0,
           "compared": [int(keep.sum()), int(keep.size)],
           "top1_equal": int((~differ & keep).sum()),
           "top1_total": int(keep.sum()),
           "top1_differ_at_near_ties": int(differ.sum()),
           "logit_scale": scale,
           "tolerance": f"|logit diff| <= {atol:.4g} at the ids, "
                        f"<= {lse_atol:.4g} on the log-sum-exp; rel L2 "
                        f"<= {SERVE_REF_REL_L2} per step; top-1 equal unless "
                        f"the reference's top-2 margin <= {atol:.4g}"}
    out["ok"] = (out["max_abs_err_at_ids"] <= atol
                 and out["lse_max_abs_err"] <= lse_atol
                 and out["rel_l2_at_ids_max"] <= SERVE_REF_REL_L2
                 and bool(np.all(margin[differ] <= atol)))
    return out


def serve_reference_tokens(vocab: int) -> np.ndarray:
    """The prompts and forced tokens of ``serve_reference`` (shared with
    ``scripts/port_reference_times.py``)."""
    return np.random.default_rng(SERVE_REF_SEED).integers(
        0, vocab, (SERVE_REF_ROWS, SERVE_REF_PROMPT + SERVE_REF_STEPS),
        dtype=np.int32)


# ---------------------------------------------------------------------------
# phases 7b-7c, 13j-13m: training
# ---------------------------------------------------------------------------

# the bags' backward: Table II's shape (dlrm_batch's ids) and a small table
# with many repeats a row; (T, R, D, P, B)
BAGS_BWD_SHAPES = ((64, 1_000_000, 64, 60, 256), (64, 100, 64, 60, 256))
DIGEST_CHUNK = 1 << 26


def tensor_digest(t):
    """Two int64 sums over a tensor's bit patterns, plain and weighted by
    position (a tensor of 4.1 G elements in chunks; a 0-dim tensor on the
    CPU included): bit-equal tensors give equal digests, and a differing
    bit changes them but with negligible chance.  A (2,) int64 tensor on
    the tensor's device."""
    import torch
    flat = t.detach().reshape(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    acc = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for i in range(0, bits.numel(), DIGEST_CHUNK):
        w = bits[i:i + DIGEST_CHUNK].long()
        pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
        acc[0] += w.sum()
        acc[1] += (w * pos).sum()
    return acc


def tree_digest(tree) -> dict:
    """name -> [plain, weighted] digest of every leaf
    (``flatten_with_paths`` names)."""
    from repro_torch.common.pytree import flatten_with_paths
    return {name: tensor_digest(leaf).tolist()
            for name, leaf in flatten_with_paths(tree)}


def bags_bits_differ(a, b) -> tuple:
    """(differing elements, max abs difference over them) of two tensors
    of one dtype: ``torch.equal`` on their bits, and where that fails a
    count in chunks (no temporary of the 4.1 G elements' size)."""
    import torch
    int_t = torch.int16 if a.element_size() == 2 else torch.int32
    a, b = a.reshape(-1), b.reshape(-1)
    if torch.equal(a.view(int_t), b.view(int_t)):
        return 0, 0.0
    n, err = 0, 0.0
    for i in range(0, a.numel(), DIGEST_CHUNK):
        x, y = a[i:i + DIGEST_CHUNK], b[i:i + DIGEST_CHUNK]
        bad = x.view(int_t) != y.view(int_t)
        k = int(bad.sum())
        if k:
            n += k
            err = max(err, float((x[bad].float() - y[bad].float()).abs()
                                 .max()))
    return n, err


def bags_backward_inputs(T, R, D, P, B, dev) -> tuple:
    """dpooled (B, T, D) bf16 from a generator on the card and ids: Table
    II's from ``dlrm_batch`` (seed 0, step 1) when R is Table II's, else
    uniform draws."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import dlrm_batch
    cfg = get_config("dlrm")
    gen = torch.Generator(device=dev).manual_seed(R + D)
    dp = torch.randn((B, T, D), generator=gen, device=dev).to(torch.bfloat16)
    if (T, R, D, P) == (cfg.n_tables, cfg.rows_per_table, cfg.emb_dim,
                        cfg.pooling):
        ids = dlrm_batch(0, 1, B, cfg)["sparse_idx"]
    else:
        ids = np.random.default_rng(R).integers(0, R, (B, T, P),
                                                dtype=np.int32)
    return dp, torch.as_tensor(ids, device=dev)


def bags_backward_check(dev) -> dict:
    """The bags' backward kernel against its plain version on the card
    (``BAGS_BWD_SHAPES``: Table II's, 983,040 entries into 8.19 GB of
    tables, and 100 rows a table, ~154 entries a row): bit for bit, and
    equal to a second launch."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref
    rows, differing, worst = [], 0, 0.0
    for T, R, D, P, B in BAGS_BWD_SHAPES:
        dp, idx = bags_backward_inputs(T, R, D, P, B, dev)
        want = ref.embedding_bag_stacked_backward_ref(dp, idx, R,
                                                      torch.bfloat16)
        row = {"shape": f"T={T} R={R} D={D} P={P} B={B}",
               "rows_touched": int(torch.unique(
                   (idx + torch.arange(T, device=dev, dtype=torch.int32)
                    [None, :, None] * R).reshape(-1)).numel())}
        got = ops.embedding_bag_stacked_backward(dp, idx, R, torch.bfloat16)
        n, err = bags_bits_differ(got, want)
        again = ops.embedding_bag_stacked_backward(dp, idx, R,
                                                   torch.bfloat16)
        n_again, _ = bags_bits_differ(again, got)
        row.update(differing=n, max_abs_err=err, repeat_differing=n_again)
        differing += n + n_again
        worst = max(worst, err)
        del got, again
        rows.append(row)
        del want, dp, idx
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = {"shapes": rows, "differing": differing, "max_abs_err": worst,
           "tolerance": "bit-equal to the plain version and to a repeat"}
    if differing:
        raise AssertionError(f"embedding_bag_backward: {differing} elements "
                             f"differ: {out}")
    return out


def bags_backward_calls(dev) -> dict:
    """At Table II's shape: the backward as one call (``torch.zeros``, the
    index, the sums: direct launches, no count), the same with the
    library's own zero fill kernel in ``torch.zeros``' place, the pieces,
    the plain version and PyTorch's two ways to the same function
    (``F.embedding_bag``'s backward, ``index_add_`` into zeros): name ->
    callable, and the shape."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref
    T, R, D, P, B = BAGS_BWD_SHAPES[0]
    dp, idx = bags_backward_inputs(T, R, D, P, B, dev)
    fn, zero = ops.backward_functions()
    stream = torch.cuda.current_stream().cuda_stream
    rows, perm = ops.backward_index(idx, R)
    out = torch.zeros((T, R, D), dtype=torch.bfloat16, device=dev)
    # the raw pointers of ``args`` live as long as ``held``, which the
    # sums' closure keeps
    held = (dp, rows, perm, out)
    args = ops.backward_args(*held[:3], P, out)

    def launch(fill="torch"):
        if fill == "torch":
            o = torch.zeros((T, R, D), dtype=torch.bfloat16, device=dev)
        else:
            o = torch.empty((T, R, D), dtype=torch.bfloat16, device=dev)
            if zero(o.data_ptr(), o.numel() * 2, stream) != 0:
                raise RuntimeError("embedding_bag_zero launch failed")
        r, p = ops.backward_index(idx, R)
        if fn(*ops.backward_args(dp, r, p, P, o), stream) != 0:
            raise RuntimeError("embedding_bag_backward launch failed")
        return o

    def sums(held=held):
        if fn(*args, stream) != 0:
            raise RuntimeError("embedding_bag_backward launch failed")

    def zero_kernel():
        if zero(out.data_ptr(), out.numel() * 2, stream) != 0:
            raise RuntimeError("embedding_bag_zero launch failed")
    # F.embedding_bag(mode="sum")'s backward as its autograd node calls it
    # (the aten op: no 8 GB table held for a forward)
    flat_rows = (idx.long() + torch.arange(T, device=dev)[None, :, None]
                 * R).reshape(-1)
    offset2bag = torch.arange(B * T, device=dev).repeat_interleave(P)
    bag_size = torch.full((B * T,), P, dtype=torch.int64, device=dev)
    no_max = torch.empty(0, dtype=torch.int64, device=dev)
    dflat = dp.view(B * T, D)
    vals = dflat[:, None].expand(B * T, P, D).reshape(-1, D)
    return {
        "launch": launch,
        "launch_kernel_fill": lambda: launch("kernel"),
        "sums": sums, "zero_kernel": zero_kernel,
        "zeros": lambda: torch.zeros((T, R, D), dtype=torch.bfloat16,
                                     device=dev),
        "index": lambda: ops.backward_index(idx, R),
        "plain": lambda: ref.embedding_bag_stacked_backward_ref(
            dp, idx, R, torch.bfloat16),
        "library": lambda: torch.ops.aten._embedding_bag_dense_backward(
            dflat, flat_rows, offset2bag, bag_size, no_max, T * R, False, 0,
            None, -1),
        "index_add": lambda: torch.zeros(
            (T * R, D), dtype=torch.bfloat16, device=dev).index_add_(
                0, flat_rows, vals),
    }, (T, R, D, P, B)


def time_bags_backward(dev, traced: dict) -> dict:
    """The bags' backward at Table II's shape: the whole function (event
    ms) as the wrapper runs it and with the zero fill kernel in
    ``torch.zeros``' place, its pieces, the plain version, and PyTorch's
    backward of ``F.embedding_bag(mode="sum")`` and ``index_add_`` into
    zeros; the bound: the tables' gradient written once, dpooled and the
    ids read once, at the card's memory rate."""
    calls, (T, R, D, P, B) = bags_backward_calls(dev)
    ms = {k: cuda_ms(calls[k], reps=5, inner=4)
          for k in ("launch", "launch_kernel_fill", "sums", "zero_kernel",
                    "zeros", "index", "library", "index_add")}
    plain = cuda_ms(calls["plain"], reps=3, inner=1)
    n_bytes = T * R * D * 2 + B * T * D * 2 + B * T * P * 4
    host = host_us(calls["launch"], n=20)
    del calls

    def for_trace():
        c, _ = bags_backward_calls(dev)
        return c["launch"], c["library"], None
    traced["embedding_bag_backward"] = for_trace
    return {"ms": ms["launch"], "ms_kernel_fill": ms["launch_kernel_fill"],
            "sums_ms": ms["sums"], "zero_kernel_ms": ms["zero_kernel"],
            "zeros_ms": ms["zeros"], "index_ms": ms["index"],
            "host_us_per_launch": host, "plain_ms": plain,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": ms["library"],
            "index_add_ms": ms["index_add"], "bytes": n_bytes,
            "shape": f"B={B} T={T} P={P} D={D} R={R}"}


def dlrm_train_run(cfg, tcfg, batches, dev, probe: bool = False) -> dict:
    """The DLRM of ``cfg`` drawn from seed 0 on the card, ``len(batches)``
    AdamW steps through ``make_train_step``: losses, gradient norms, wall
    s a step, the kernels' launches over the steps and the digest of the
    final parameters and moments.  With ``probe``: ``DLRM.loss`` on the
    first batch before the steps, the peak bytes, and one more step timed
    in its two halves (loss and gradient; the optimizer)."""
    import torch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import DLRM
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import (accumulate_grads,
                                              init_train_state,
                                              make_grad_fn, make_train_step)
    torch.cuda.reset_peak_memory_stats()
    model = DLRM(cfg, device=dev, seed=0)
    params, opt = init_train_state(model, None, tcfg)
    step = make_train_step(model, tcfg)
    out = {}
    if probe:
        with torch.no_grad():
            out["module_loss"] = float(model.loss(batches[0]))
    torch.cuda.synchronize()
    ops.reset_launches()
    losses, norms, secs = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    out.update(losses=losses, grad_norms=norms, step_s=secs,
               launches=dict(ops.LAUNCHES), digest=tree_digest((params, opt)))
    if probe:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        grad_fn = make_grad_fn(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = accumulate_grads(grad_fn, params, batches[0], None)
        float(loss)
        t1 = time.perf_counter()
        adamw_update(params, grads, opt, tcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.update(grad_s=t1 - t0, optimizer_s=t2 - t1,
                   optimizer_share=(t2 - t1) / (t2 - t0))
        del grads
    del model, params, opt, step
    torch.cuda.empty_cache()
    return out


def train_dlrm(gpu: str, dev) -> dict:
    """The Table II DLRM (8.19 GB of tables, drawn from seed 0), B=256
    from ``dlrm_batch``, the default ``embedding_impl`` (the kernels):
    three AdamW steps (``TrainConfig`` defaults) through
    ``make_train_step``, twice, and once with the plain bags in place of
    both kernels.  Finite losses and norms; step 1's loss equal to
    ``DLRM.loss`` on its batch; the two kernel runs and the plain run
    equal bit for bit (losses, parameters, moments); one launch of each
    kernel a step.  Returns the kernels' launches of the first run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import dlrm_batch
    cfg = get_config("dlrm")
    tcfg = TrainConfig()
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                dlrm_batch(0, i, 256, cfg).items()} for i in range(3)]
    t0 = time.perf_counter()
    a = dlrm_train_run(cfg, tcfg, batches, dev, probe=True)
    b = dlrm_train_run(cfg, tcfg, batches, dev)
    plain = dlrm_train_run(dataclasses.replace(cfg, embedding_impl="torch"),
                           tcfg, batches, dev)
    line = {"phase": "train_dlrm", "gpu": gpu, "batch": 256,
            "tables_bytes": cfg.n_tables * cfg.rows_per_table
            * cfg.emb_dim * 2, "steps": len(batches),
            "losses": a["losses"], "grad_norms": a["grad_norms"],
            "module_loss": a["module_loss"], "step_s": a["step_s"],
            "plain_step_s": plain["step_s"],
            "grad_s": a["grad_s"], "optimizer_s": a["optimizer_s"],
            "optimizer_share": a["optimizer_share"],
            "peak_bytes": a["peak_bytes"], "launches": a["launches"],
            "repeat_equal": a["digest"] == b["digest"]
            and a["losses"] == b["losses"],
            "plain_equal": a["digest"] == plain["digest"]
            and a["losses"] == plain["losses"],
            "leaves": len(a["digest"]), "seconds": time.perf_counter() - t0}
    emit(line)
    if not all(math.isfinite(x) for x in a["losses"] + a["grad_norms"]):
        raise AssertionError(f"train_dlrm: non-finite {line}")
    if a["losses"][0] != a["module_loss"]:
        raise AssertionError(f"train_dlrm: step 1's loss {a['losses'][0]} "
                             f"is not DLRM.loss {a['module_loss']}")
    if a["launches"] != {"embedding_bag_rows": 3,
                         "embedding_bag_backward": 3}:
        raise AssertionError(f"train_dlrm: launches {a['launches']}")
    if plain["launches"] != {"embedding_bag_rows": 0,
                             "embedding_bag_backward": 0}:
        raise AssertionError(f"train_dlrm: the plain bags launched "
                             f"{plain['launches']}")
    for other, what in ((b, "a repeat"), (plain, "the plain bags' run")):
        bad = [k for k in a["digest"] if a["digest"][k] != other["digest"][k]]
        if bad or a["losses"] != other["losses"]:
            raise AssertionError(f"train_dlrm: differs from {what}: leaves "
                                 f"{bad}, losses {a['losses']} vs "
                                 f"{other['losses']}")
    return a["launches"]


# ---------------------------------------------------------------------------
# phase 7d: the device mesh (mesh_dlrm, mesh_elastic, mesh_moe, mesh_gpipe):
# one process a mesh position, the four sharing the card over gloo
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_SEED = 7
MESH_DLRM_BATCH = 256
MESH_DLRM_STEPS = 3
MESH_GROUP_TIMEOUT_S = 300.0     # every collective of the mesh job
MESH_JOIN_S = 600.0
MESH_EP = {"expert": ("data",)}  # the classic DLRM layout: tables over data
# the mesh DLRM's limits against one process (mesh_elastic's step 4 on 2
# ranks against 4 takes the first three), each above the sound runs'
# readings (the mesh's and a one-process control's) and below the
# planted faults' (PERF.md §6): step 1's loss (absolute; sound 6e-8,
# faults 6.3e-3 and 1.1e-2) and norm (relative); the later steps' (Adam's
# first steps move a weight by about lr x sign(g): a gradient near 0 that
# rounds the other way moves it by 2 lr, and the runs part); the relative
# L2 distance of step 1's gradient (mu after step 1; sound 1.3e-2, faults
# 1.0-2.1), of the 3 steps' update and of the final moments, at the rows
# the batches touch and over each MLP leaf
MESH_DLRM_PERTURB = 1e-2       # the control's step-1 MLP gradient, rel.
MESH_DLRM_TOL = {"loss1": 1e-5, "norm1": 1e-4, "loss": 1e-3, "norm": 5e-3,
                 "grad1": 0.1, "update": 0.5, "moments": 0.5}
# mesh_elastic's rows a table: a run may write at most 45 GiB to disk,
# and Table II's whole state is 49.9 GB in the reference's checkpoint
# layout (bf16 tables widened to float32)
MESH_ELASTIC_ROWS = 250_000
# 4 rows, cut from 8 to keep chip_smoke.py near 900 s on a slower host
MESH_MOE_ROWS, MESH_MOE_SEQ = 4, 512
# capacity factors with no slot dropped on these weights (their routing
# is skewed: at 8, tp's buffers, 8x the mean load, dropped 178 slots);
# ep_a2a's buffers and its psum over model grow as the factor squared
MESH_MOE_CAPACITY = {"ep_a2a": 4.0, "tp": 24.0}
MESH_MOE_CASES = (((4, 1), "ep_a2a"), ((2, 2), "ep_a2a"), ((2, 2), "tp"))
MESH_MOE_TOL = 1e-3              # rel. L2 of the routed-alike rows, float32
MESH_GPIPE = (8, 2, 8, 2048)     # layers (of 22), a stage, microbatches, S


def mesh_log(rank: int, what: str) -> None:
    print(f"chip_smoke t={time.time() - RUN_T0:.1f}s [mesh r{rank}] {what}",
          file=sys.stderr, flush=True)


def dlrm_hashed(cfg, seed: int, dev, tables: range | None = None) -> dict:
    """Table II DLRM weights by ``hashed_bf16`` (the same bits on every
    rank, no broadcast): table t from seed ``seed * 1_000_003 + t`` at std
    0.02 (the models' rule), only the tables of ``tables`` (all by
    default); the MLPs' weights at std sqrt(2 / fan_in) and biases at 0.1
    (``dlrm_numpy_params``' scales: activations keep their scale through
    the 19 ReLU layers), float32."""
    import torch
    from repro_torch.models.dlrm import param_shapes
    shapes = param_shapes(cfg)
    T, R, D = shapes["tables"][0]
    tables = range(T) if tables is None else tables
    out = {"tables": torch.stack([
        hashed_bf16((R, D), seed * 1_000_003 + t, 0.02, dev)
        for t in tables])}
    k = T
    for part in ("bot", "top"):
        out[part] = {}
        for name in sorted(shapes[part]):
            shape = shapes[part][name][0]
            k += 1
            std = math.sqrt(2.0 / shape[0]) if len(shape) == 2 else 0.1
            out[part][name] = hashed_bf16(shape, seed * 1_000_003 + k, std,
                                          dev).float()
    return out


def hashed_blocks(shapes, seed: int, device, cut):
    """``hashed_params(shapes, seed, device)`` with ``cut(path, leaf)``
    applied to each leaf as it is drawn (a rank's block: no rank holds the
    whole tree at once)."""
    count = [0]

    def walk(node, name, parent, path):
        if isinstance(node, dict):
            return {k: walk(node[k], k, name, path + (k,))
                    for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v, name, parent, path + (str(i),))
                    for i, v in enumerate(node)]
        count[0] += 1
        leaf = hashed_bf16(tuple(node), seed * 1_000_003 + count[0],
                           _init_std(name, tuple(node), parent), device,
                           mean=_LEAF_MEAN.get(name, 0.0))
        return cut(path, leaf)
    return walk(shapes, "", "", ())


def _untouched_digests(tables, touched) -> list:
    """Per table, the digest of its rows with the touched ones zeroed."""
    out = []
    for t in range(tables.shape[0]):
        x = tables[t].clone()
        x[touched[t]] = 0
        out.append(tensor_digest(x).tolist())
        del x
    return out


def _skeleton(tree, dev):
    """A tree of ``tree``'s structure with empty leaves on ``dev`` (what
    ``checkpoint.restore`` reads: names and the device)."""
    import torch
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda _: torch.empty(0, device=dev), tree)


def _touched_rows(batches, cfg, dev):
    """(T, K) int64 on ``dev``: each table's rows that any of ``batches``
    names (sorted, padded with its first), the only rows whose values a
    step moves by more than the weight decay every row takes alike."""
    import torch
    ids = [np.unique(np.concatenate([np.asarray(b["sparse_idx"].cpu())[:, t]
                                     .reshape(-1) for b in batches]))
           for t in range(cfg.n_tables)]
    K = max(len(x) for x in ids)
    out = np.stack([np.concatenate([x, np.full(K - len(x), x[0])])
                    for x in ids])
    return torch.as_tensor(out, device=dev)


def _dlrm_view(tree, touched, specs=None, mesh=None) -> dict:
    """What the mesh DLRM's checks hold of a parameter, gradient or moment
    tree ``{"tables", "bot", "top"}``: each table's ``touched`` rows
    ``(T, K, D)`` and the MLPs' leaves whole, float32 copies in host memory
    (0.74 GB of rows at Table II's 3 batches: the card holds the mesh's
    state beside them).  Over a mesh the tables' blocks are all-gathered
    over data and the MLPs gathered by ``specs`` (every rank takes part),
    and only the mesh's rank 0, which holds the runs against each other,
    gets the view (the others None)."""
    import torch
    from repro_torch.common import comm
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.common.sharding import flatten_specs, gather_full
    tables = tree["tables"]
    T_loc = tables.shape[0]
    t0 = mesh.axis_index("data") * T_loc if mesh is not None else 0
    rows = torch.stack([tables[t][touched[t0 + t]] for t in range(T_loc)])
    mlp = flatten_with_paths({"bot": tree["bot"], "top": tree["top"]})
    def host(x):
        return x.to("cpu", torch.float32, copy=True)
    if mesh is None:
        return {"rows": host(rows), "mlp": {n: host(x) for n, x in mlp}}
    spec_of = dict(flatten_specs({"bot": specs["bot"], "top": specs["top"]}))
    rows = comm.all_gather(rows, mesh, "data")
    mlp = {n: gather_full(x, spec_of[n], mesh) for n, x in mlp}
    if mesh.rank != 0:
        return None
    return {"rows": host(rows), "mlp": {n: host(x) for n, x in mlp.items()}}


def _rel(a, b) -> float:
    """||a - b|| / ||b|| of two float32 tensors (||a - b|| where b is
    0)."""
    import torch
    d = float(torch.linalg.vector_norm(a - b))
    nb = float(torch.linalg.vector_norm(b))
    return d / nb if nb else d


def _views_rel(got, want) -> dict:
    """Two ``_dlrm_view``s apart: the relative L2 distance of the tables'
    rows (all of them), and the largest over the MLPs' leaves."""
    return {"tables": _rel(got["rows"], want["rows"]),
            "mlp": max(_rel(got["mlp"][n], want["mlp"][n])
                       for n in want["mlp"])}


def _views_sub(a, b) -> dict:
    """``a - b`` of two ``_dlrm_view``s (a tree's update)."""
    return {"rows": a["rows"] - b["rows"],
            "mlp": {n: a["mlp"][n] - b["mlp"][n] for n in a["mlp"]}}


def _faulty_grads(model, batch, T_loc: int, touched) -> dict:
    """Planted faults of the mesh step, computed in one process: the loss
    and the gradient (``_dlrm_view`` at ``touched``) of ``batch`` when
    the all-to-all delivers each rank's bags one rank's block of tables
    off (``a2a_off``: table t's bag in slot t + T_loc -- the tables and
    their ids rolled by T_loc, the tables' gradient read back at the
    rolled positions) and when each rank takes its block of the ids one
    rank off (``ids_off``: the ids rolled by T_loc), beside the sound
    step's (``sound``)."""
    import torch
    from repro_torch.train.train_step import make_grad_fn
    grad_fn = make_grad_fn(model)
    params = model.param_tree()
    out = {}
    for name in ("sound", "a2a_off", "ids_off"):
        p, b, at = params, batch, touched
        if name != "sound":
            b = dict(batch, sparse_idx=torch.roll(batch["sparse_idx"], T_loc,
                                                  dims=1))
        if name == "a2a_off":
            p = dict(params, tables=torch.roll(params["tables"], T_loc,
                                               dims=0))
            at = torch.roll(touched, T_loc, dims=0)
        loss, g = grad_fn(p, b)
        view = _dlrm_view(g, at)
        if name == "a2a_off":
            view["rows"] = torch.roll(view["rows"], -T_loc, dims=0)
        out[name] = {"loss": float(loss), "grad": view}
        del p, g
        torch.cuda.empty_cache()
    return out


def _perturbed_step(model, tcfg, rel: float):
    """``make_train_step``'s one-process step (no accumulation) whose first
    gradient has its MLP leaves multiplied by ``1 + rel x N(0, 1)``
    (drawn from ``MESH_SEED``): a step-1 gradient apart from the sound one
    by about ``rel``, as the mesh's partial sums in bf16 put it."""
    import torch
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import make_grad_fn
    grad_fn = make_grad_fn(model)

    def step(params, opt, batch):
        loss, g = grad_fn(params, batch)
        if int(opt["count"]) == 0:
            gen = torch.Generator(device=model.device).manual_seed(MESH_SEED)
            for part in ("bot", "top"):
                for name in sorted(g[part]):
                    x = g[part][name]
                    x.mul_(1 + rel * torch.randn(x.shape, generator=gen,
                                                 device=x.device))
        params, opt, m = adamw_update(params, g, opt, tcfg)
        return params, opt, dict(m, loss=loss)
    return step


def mesh_dlrm_single(cfg, tcfg, batches, dev, faults: bool = True,
                     perturb: float = 0.0) -> dict:
    """Rank 0 alone: the Table II DLRM of ``dlrm_hashed`` in one process:
    ``DLRM.loss`` on the first batch, the planted faults
    (``_faulty_grads``, unless ``faults`` is False), then 3 AdamW steps
    (``make_train_step``'s; with ``perturb``, ``_perturbed_step``'s): the
    losses, norms and the ``_dlrm_view``s the mesh run is held against:
    step 1's mu at the first batch's rows, the parameters before and
    after, the final moments at every batch's rows, and the untouched
    rows' digests."""
    import torch
    from repro_torch.models import DLRM
    from repro_torch.train.train_step import init_train_state, make_train_step
    model = DLRM(cfg, device=dev, params=dlrm_hashed(cfg, MESH_SEED, dev))
    touched1 = _touched_rows(batches[:1], cfg, dev)
    touched = _touched_rows(batches, cfg, dev)
    with torch.no_grad():
        module_loss = float(model.loss(batches[0]))
    faults = _faulty_grads(model, batches[0], cfg.n_tables // MESH_RANKS,
                           touched1) if faults else None
    params, opt = init_train_state(model, None, tcfg)
    p0 = _dlrm_view(params, touched)
    step = _perturbed_step(model, tcfg, perturb) if perturb else \
        make_train_step(model, tcfg)
    losses, norms, secs = [], [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        if i == 0:
            mu1 = _dlrm_view(opt["mu"], touched1)
    out = {"module_loss": module_loss, "faults": faults, "losses": losses,
           "norms": norms, "step_s": secs, "mu1": mu1, "p0": p0,
           "p": _dlrm_view(params, touched),
           "mu": _dlrm_view(opt["mu"], touched),
           "nu": _dlrm_view(opt["nu"], touched),
           "untouched": _untouched_digests(params["tables"], touched)}
    del model, params, opt, step
    torch.cuda.empty_cache()
    return out


def _bags_launches() -> dict:
    from repro_torch.kernels.embedding_bag import ops
    return dict(ops.LAUNCHES)


class capture_bags:
    """Within the block, the first call of each bag kernel's wrapper on
    the path keeps a copy of its inputs: ``forward`` (ids, out dtype) and
    ``backward`` (dpooled, ids, rows a table, dtype), for holding the
    kernels against their plain versions at a mesh rank's shapes once
    the run is over."""

    def __enter__(self):
        from repro_torch.kernels.embedding_bag import ops
        self._ops = ops
        self._fwd, self._bwd = ops._stacked, ops.embedding_bag_stacked_backward
        self.forward = self.backward = None

        def fwd(tables, idx, out_dtype):
            if self.forward is None:
                self.forward = (idx.clone(), out_dtype)
            return self._fwd(tables, idx, out_dtype)

        def bwd(dpooled, idx, rows_per_table, *rest):
            if self.backward is None:
                self.backward = (dpooled.clone(), idx.clone(),
                                 rows_per_table, *rest)
            return self._bwd(dpooled, idx, rows_per_table, *rest)
        ops._stacked, ops.embedding_bag_stacked_backward = fwd, bwd
        return self

    def __exit__(self, *exc):
        self._ops._stacked = self._fwd
        self._ops.embedding_bag_stacked_backward = self._bwd


def bags_rank_check(tables, cap: "capture_bags") -> dict:
    """The bag kernels at a mesh rank's shapes (its block of tables,
    every row of the global batch), on the inputs the path gave them
    (``cap``): the forward over ``tables`` and the backward, each against
    its plain version, bit for bit.  Its launches are not the path's."""
    import torch
    from repro_torch.kernels.embedding_bag import ops, ref
    idx, out_dtype = cap.forward
    dp, bidx, R, *rest = cap.backward
    T, _, D = tables.shape
    out = {"shape": f"T={T} R={R} D={D} P={idx.shape[2]} B={idx.shape[0]}"}
    with torch.no_grad():
        got = ops.embedding_bag_stacked(tables, idx, out_dtype)
        want = ref.embedding_bag_stacked_ref(tables, idx, out_dtype)
        out["forward_differing"], err_f = bags_bits_differ(got, want)
        del got, want
        got = ops.embedding_bag_stacked_backward(dp, bidx, R, *rest)
        want = ref.embedding_bag_stacked_backward_ref(dp, bidx, R, *rest)
        out["backward_differing"], err_b = bags_bits_differ(got, want)
        del got, want
    torch.cuda.empty_cache()
    out["max_abs_err"] = max(err_f, err_b)
    return out


def _dlrm_mesh_run(rank, dev, cfg, tcfg, n_steps: int, watch=None) -> dict:
    """Every rank: the DLRM of ``cfg`` over (data=4), the tables over
    data, ZeRO-1 (the gradients reduce-scattered to its layout),
    ``n_steps`` steps on the global batches of ``dlrm_batch`` (the bag
    kernels' first inputs captured): the live state and each step's
    numbers.  ``watch(i, params, opt, run)`` sees the state before the
    steps (``i`` 0) and after each."""
    import torch
    from repro_torch.common import comm
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import DLRM
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, mesh_layout)
    mesh = make_mesh((MESH_RANKS,), ("data",))
    T_loc = cfg.n_tables // MESH_RANKS
    torch.cuda.reset_peak_memory_stats()
    local = dlrm_hashed(cfg, MESH_SEED, dev,
                        range(rank * T_loc, (rank + 1) * T_loc))
    model = DLRM(cfg, device=dev, params=local, mesh=mesh,
                 rules_overrides=MESH_EP)
    grad_specs = mesh_layout(model, tcfg).moments
    params, opt = init_train_state(model, None, tcfg, grad_specs)
    step = make_train_step(model, tcfg, grad_specs)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                dlrm_batch(0, i, MESH_DLRM_BATCH, cfg).items()}
               for i in range(n_steps + 1)]
    run = {"mesh": mesh, "layout": step.layout, "batches": batches}
    if watch is not None:
        watch(0, params, opt, run)
    ops.reset_launches()
    losses, norms, secs, counts = [], [], [], []
    with capture_bags() as cap:
        for i, b in enumerate(batches[:n_steps]):
            comm.reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(comm.counters())
            if watch is not None:
                watch(i + 1, params, opt, run)
    return dict(run, model=model, params=params, opt=opt, step=step,
                losses=losses, norms=norms, step_s=secs, counts=counts,
                launches=_bags_launches(), bags=cap,
                peak_bytes=torch.cuda.max_memory_allocated())


def _dlrm_readings(run, single) -> dict:
    """A 3-step DLRM run (``losses``, ``norms`` and the ``_dlrm_view``s of
    ``mesh_dlrm_single``'s names) against the one-process run: step 1's
    loss against ``DLRM.loss``, each step's loss (absolute) and norm
    (relative), step 1's gradient, the update and the final moments
    (``_views_rel``)."""
    s = single
    return {
        "step1_loss_diff": abs(run["losses"][0] - s["module_loss"]),
        "loss_diffs": [abs(a - b) for a, b in zip(run["losses"],
                                                  s["losses"])],
        "norm_rels": [abs(a - b) / abs(b) for a, b in zip(run["norms"],
                                                          s["norms"])],
        "grad1_rel": _views_rel(run["mu1"], s["mu1"]),
        "update_rel": _views_rel(_views_sub(run["p"], run["p0"]),
                                 _views_sub(s["p"], s["p0"])),
        "moments_rel": {m: _views_rel(run[m], s[m]) for m in ("mu", "nu")}}


def mesh_dlrm_rank(rank, dev, single) -> dict:
    """Every rank: the Table II DLRM over (data=4), 3 steps (the
    ``_dlrm_mesh_run``), held on rank 0 against the one-process run
    (``single``): step 1's loss and mu (the gradient), the losses and
    norms, the update of the parameters and the final moments (the
    ``_dlrm_view``s), the untouched rows bit for bit, and the planted
    faults' readings; then the bag kernels at this rank's shapes."""
    import torch
    from repro_torch.common import comm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.dlrm import comm_profile
    cfg = get_config("dlrm")
    views = {}

    def watch(i, params, opt, run):
        mesh, layout = run["mesh"], run["layout"]
        if i == 0:
            batches = run["batches"][:MESH_DLRM_STEPS]
            views["touched1"] = _touched_rows(batches[:1], cfg, dev)
            views["touched"] = _touched_rows(batches, cfg, dev)
            views["p0"] = _dlrm_view(params, views["touched"],
                                     layout.params, mesh)
        elif i == 1:
            views["mu1"] = _dlrm_view(opt["mu"], views["touched1"],
                                      layout.moments, mesh)
    st = _dlrm_mesh_run(rank, dev, cfg, TrainConfig(), MESH_DLRM_STEPS, watch)
    mesh, params, layout, opt = st["mesh"], st["params"], st["layout"], \
        st["opt"]
    mesh_log(rank, f"mesh_dlrm steps {st['step_s']}")
    line = {"losses": st["losses"], "grad_norms": st["norms"],
            "step_s": st["step_s"], "peak_bytes": st["peak_bytes"],
            "launches": st["launches"], "bytes_per_step": st["counts"],
            "transport": mesh.backend}
    touched = views["touched"]
    T_loc = params["tables"].shape[0]
    t0 = rank * T_loc
    p3 = _dlrm_view(params, touched, layout.params, mesh)
    mu3 = _dlrm_view(opt["mu"], touched, layout.moments, mesh)
    nu3 = _dlrm_view(opt["nu"], touched, layout.moments, mesh)
    digests = comm.all_gather_object(_untouched_digests(
        params["tables"], touched[t0:t0 + T_loc]))
    if rank == 0:
        s = single
        line["touched_rows"] = [int(views["touched1"].shape[1]),
                                int(touched.shape[1])]
        line.update(_dlrm_readings(dict(
            losses=st["losses"], norms=st["norms"], mu1=views["mu1"],
            p0=views["p0"], p=p3, mu=mu3, nu=nu3), s))
        line["control"] = dict(_dlrm_readings(s["control"], s),
                               losses=s["control"]["losses"],
                               step_s=s["control"]["step_s"])
        line["params_max_abs_diff"] = {
            "tables": float((p3["rows"] - s["p"]["rows"]).abs().max()),
            "mlp": max(float((p3["mlp"][n] - s["p"]["mlp"][n]).abs().max())
                       for n in p3["mlp"])}
        line["p0_bit_equal"] = bool(
            torch.equal(views["p0"]["rows"], s["p0"]["rows"])
            and all(torch.equal(views["p0"]["mlp"][n], s["p0"]["mlp"][n])
                    for n in s["p0"]["mlp"]))
        line["tables_untouched_bit_equal"] = (
            [d for r in digests for d in r] == s["untouched"])
        sound = s["faults"]["sound"]
        line["grad_fn_loss"] = sound["loss"]
        line["single"] = {k: s[k] for k in ("module_loss", "losses",
                                            "norms", "step_s")}
        line["planted"] = {
            f: {"step1_loss_diff": abs(s["faults"][f]["loss"]
                                       - sound["loss"]),
                "grad1_rel": _views_rel(s["faults"][f]["grad"],
                                        sound["grad"])}
            for f in ("a2a_off", "ids_off")}
        line["comm_profile"] = comm_profile(cfg)
        from repro_torch.core.workload import DLRMCommSpec
        spec = DLRMCommSpec()
        line["dlrm_comm_spec"] = {
            "allreduce_bytes": spec.allreduce_bytes,
            "alltoall_fwd_bytes": spec.alltoall_fwd_bytes,
            "alltoall_bwd_bytes": spec.alltoall_bwd_bytes}
    tables, cap = params["tables"], st["bags"]
    del st, params, opt, layout, views, p3, mu3, nu3
    torch.cuda.empty_cache()
    line["bags_check"] = bags_rank_check(tables, cap)
    del tables, cap
    torch.cuda.empty_cache()
    comm.barrier()
    return line


def mesh_elastic_rank(rank, dev, tmp) -> dict:
    """The DLRM at Table II's widths with ``MESH_ELASTIC_ROWS`` rows a
    table over (data=4), 3 steps, its state saved with its specs (every
    rank its blocks), then step 4 on the 4 ranks; the checkpoint restored
    into one process (rank 0: every leaf against the 4 ranks' blocks, bit
    for bit), then onto a (data=2) mesh of ranks 0 and 1 (each block
    against the one-process restore's, bit for bit), which take step 4:
    its loss, norm and gradient (the change of mu) held on rank 0 against
    the 4 ranks', and the bag kernels at the 2 ranks' shapes."""
    import torch
    from repro_torch.checkpoint import restore, save
    from repro_torch.common import comm
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.common.sharding import (MeshRules, flatten_specs,
                                             shard_slices)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import DLRM
    from repro_torch.models.dlrm import param_defs, param_specs
    from repro_torch.train.optimizer import opt_state_specs
    from repro_torch.train.train_step import make_train_step, mesh_layout
    cfg = dataclasses.replace(get_config("dlrm"),
                              rows_per_table=MESH_ELASTIC_ROWS)
    tcfg = TrainConfig()
    st = _dlrm_mesh_run(rank, dev, cfg, tcfg, MESH_DLRM_STEPS)
    mesh, layout = st["mesh"], st["layout"]
    ckpt = str(tmp / "mesh_ckpt")
    o_specs = opt_state_specs(layout.params, param_defs(cfg), mesh,
                              zero1=True, keep_master=False)
    specs = (layout.params, o_specs)
    tree = (st["params"], st["opt"])
    digests = {n: tensor_digest(x).tolist()
               for n, x in flatten_with_paths(tree)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save(ckpt, MESH_DLRM_STEPS, tree, specs,
         extra_meta={"next_step": MESH_DLRM_STEPS}, mesh=mesh)
    save_s = time.perf_counter() - t0
    mesh_log(rank, f"mesh_elastic saved in {save_s:.1f} s")
    # ---- step 4 on the 4 ranks --------------------------------------------
    b4 = st["batches"][-1]
    touched4 = _touched_rows([b4], cfg, dev)
    mu3 = _dlrm_view(st["opt"]["mu"], touched4, layout.moments, mesh)
    _, _, m = st["step"](st["params"], st["opt"], b4)
    mu4 = _dlrm_view(st["opt"]["mu"], touched4, layout.moments, mesh)
    four = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "dmu": _views_sub(mu4, mu3) if rank == 0 else None}
    all_digests = comm.all_gather_object(digests)
    line = {"save_s": save_s, "losses": st["losses"], "step_s": st["step_s"],
            "ckpt_bytes": sum(f.stat().st_size for f in
                              (tmp / "mesh_ckpt").rglob("*.npy"))}
    skeleton = _skeleton(tree, dev)
    del tree, m, st, mu3, mu4
    torch.cuda.empty_cache()
    mesh2 = make_mesh((2,), ("data",), ranks=(0, 1))
    if mesh2 is not None:
        specs2 = param_specs(cfg, MeshRules.create(mesh2, MESH_EP))
        o_specs2 = opt_state_specs(specs2, param_defs(cfg), mesh2,
                                   zero1=True, keep_master=False)
    comm.barrier()
    # ---- into one process: rank 0, the others waiting -------------------
    want2 = {}
    if rank == 0:
        t0 = time.perf_counter()
        (p1, o1), meta = restore(ckpt, MESH_DLRM_STEPS, skeleton, device=dev)
        torch.cuda.synchronize()
        line["restore_one_s"] = time.perf_counter() - t0
        spec_of = dict(flatten_specs(specs))
        spec2_of = dict(flatten_specs((specs2, o_specs2)))
        bad = []
        for name, x in flatten_with_paths((p1, o1)):
            for r in range(MESH_RANKS):
                idx = shard_slices(tuple(x.shape), spec_of[name], mesh, r)
                if tensor_digest(x[idx]).tolist() != all_digests[r][name]:
                    bad.append((name, r))
            want2[name] = [tensor_digest(x[shard_slices(
                tuple(x.shape), spec2_of[name], mesh2, r)]).tolist()
                for r in range(2)]
        line["restored_bit_equal"] = not bad
        line["leaves"] = len(spec_of)
        line["meta"] = meta
        if bad:
            raise AssertionError(f"mesh_elastic: the one-process restore "
                                 f"differs from the ranks' blocks: {bad}")
        del p1, o1
        torch.cuda.empty_cache()
    comm.barrier()
    # ---- onto (data=2): ranks 0 and 1 -----------------------------------
    mine2, two = {}, None
    if mesh2 is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p2, o2), _ = restore(ckpt, MESH_DLRM_STEPS, skeleton, mesh=mesh2,
                              specs=(specs2, o_specs2), device=dev)
        torch.cuda.synchronize()
        line["restore_two_s"] = time.perf_counter() - t0
        mine2 = {n: tensor_digest(x).tolist()
                 for n, x in flatten_with_paths((p2, o2))}
        model2 = DLRM(cfg, device=dev, params=p2, mesh=mesh2,
                      rules_overrides=MESH_EP)
        p2 = model2.param_tree()
        layout2 = mesh_layout(model2, tcfg)
        step2 = make_train_step(model2, tcfg, layout2.moments)
        b = {k: torch.as_tensor(v, device=dev) for k, v in dlrm_batch(
            0, MESH_DLRM_STEPS, MESH_DLRM_BATCH, cfg).items()}
        mu3 = _dlrm_view(o2["mu"], touched4, layout2.moments, mesh2)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_bags() as cap:
            p2, o2, m2 = step2(p2, o2, b)
            loss2, norm2 = float(m2["loss"]), float(m2["grad_norm"])
        torch.cuda.synchronize()
        mu4 = _dlrm_view(o2["mu"], touched4, layout2.moments, mesh2)
        two = {"loss": loss2, "grad_norm": norm2,
               "step_s": time.perf_counter() - t0,
               "launches": _bags_launches(),
               "dmu": _views_sub(mu4, mu3) if rank == 0 else None}
        tables = p2["tables"]
        del model2, p2, o2, step2, mu3, mu4
        torch.cuda.empty_cache()
        line["bags_check_two"] = bags_rank_check(tables, cap)
        del tables, cap
        torch.cuda.empty_cache()
    got2 = comm.all_gather_object(mine2)
    if rank == 0:
        line["restored_two_bit_equal"] = all(
            got2[r][n] == want2[n][r] for n in want2 for r in range(2))
        n_half = cfg.n_tables // 2
        line["step4_four"] = {k: four[k] for k in ("loss", "grad_norm")}
        line["step4_two"] = {k: two[k] for k in ("loss", "grad_norm",
                                                  "step_s", "launches")}
        line["step4_loss_diff"] = abs(two["loss"] - four["loss"])
        line["step4_norm_rel"] = abs(two["grad_norm"] - four["grad_norm"]) \
            / four["grad_norm"]
        line["step4_grad_rel"] = _views_rel(two["dmu"], four["dmu"])
        # the planted fault: the two ranks' blocks of tables swapped
        line["planted_blocks_swapped_rel"] = _rel(
            torch.roll(two["dmu"]["rows"], n_half, dims=0),
            four["dmu"]["rows"])
    del four, two
    torch.cuda.empty_cache()
    comm.barrier()
    return line


def _moe_cfg(impl: str = "dense"):
    return arch_config("deepseek-v2-236b", 2, moe_impl=impl,
                       capacity_factor=MESH_MOE_CAPACITY.get(impl, 1.25))


def _moe_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(MESH_SEED).integers(
        0, vocab, (MESH_MOE_ROWS, MESH_MOE_SEQ), dtype=np.int32)


def mesh_moe_single(dev) -> dict:
    """Rank 0 alone: DeepSeek-V2 at full width, 2 layers (1 dense + 1
    MoE), ``hashed_params`` from ``MESH_SEED``, prefill of the
    ``MESH_MOE_ROWS`` rows on the dense path (every expert for every token: the reference's single
    device semantics), float32 and bf16 activations: last logits and the
    MoE layer's expert ids."""
    import torch
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import Model
    cfg = _moe_cfg()
    model = Model(cfg, device=dev)
    params = hashed_params(tree_map(lambda d: d.shape, model.param_defs()),
                           MESH_SEED, dev)
    toks = _moe_tokens(cfg.vocab)
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model.compute_dtype = dt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_routing() as routing:
            logits, _ = model.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        out[name] = {"logits": logits.float().cpu().numpy(),
                     "experts": routing.calls[0].cpu().numpy().reshape(
                         MESH_MOE_ROWS, MESH_MOE_SEQ, -1),
                     "s": time.perf_counter() - t0}
    del model, params
    torch.cuda.empty_cache()
    return out


def mesh_moe_rank(rank, dev) -> dict:
    """Every rank: the same model over each mesh of ``MESH_MOE_CASES``
    (this rank's rows, the experts' blocks, every other leaf gathered for
    the compute), float32 and bf16: its rows' last logits, their expert
    ids at the MoE layer, dropped slots, the all-to-all bytes."""
    import torch
    from repro_torch.common import comm
    from repro_torch.common.pytree import tree_map
    from repro_torch.common.sharding import flatten_specs, local_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models import moe as MOE
    toks = _moe_tokens(_moe_cfg().vocab)
    out = {}
    for shape, impl in MESH_MOE_CASES:
        cfg = _moe_cfg(impl)
        mesh = make_mesh(shape, ("data", "model"))
        model = Model(cfg, device=dev, mesh=mesh)
        spec_of = dict(flatten_specs(model.param_specs()))
        params = hashed_blocks(
            tree_map(lambda d: d.shape, model.param_defs()), MESH_SEED, dev,
            lambda path, x: local_shard(x, spec_of[".".join(path)],
                                        mesh).clone())
        torch.cuda.empty_cache()
        n_data = shape[0]
        rows = MESH_MOE_ROWS // n_data
        i = mesh.axis_index("data")
        mine = toks[i * rows:(i + 1) * rows]
        case = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model.compute_dtype = dt
            comm.reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with capture_routing() as routing, \
                    MOE.count_dropped() as dropped:
                logits, _ = model.prefill(params, {"tokens": mine})
            torch.cuda.synchronize()
            case[name] = {"logits": logits.float().cpu().numpy(),
                          "experts": routing.calls[0].cpu().numpy()
                          .reshape(rows, MESH_MOE_SEQ, -1),
                          "s": time.perf_counter() - t0,
                          "dropped": int(dropped),
                          "bytes": comm.counters()}
        case["rows"] = (i * rows, (i + 1) * rows)
        out[f"{impl}_{shape[0]}x{shape[1]}"] = case
        del model, params
        torch.cuda.empty_cache()
    return out


def mesh_gpipe_rank(rank, dev) -> dict:
    """Every rank a stage of (stage=4): TinyLlama's decoder layers at full
    width, ``MESH_GPIPE``'s 8 of 22 layers, 2 a stage, 8 microbatches of
    1 x 2,048 tokens' embeddings forward; rank 0 also runs the 8 layers
    one after another over the same microbatches (the same ops and
    shapes): bit for bit."""
    import torch
    from repro_torch.common import comm
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models import transformer as T
    from repro_torch.train.pipeline import gpipe
    n_layers, per, n_micro, S = MESH_GPIPE
    cfg = arch_config("tinyllama-1.1b", n_layers)
    model = Model(cfg, device=dev)
    params = hashed_params(tree_map(lambda d: d.shape, model.param_defs()),
                           MESH_SEED, dev)
    layers = params["groups"][0]["l0"]          # stacked (8, ...)
    kind = model.groups[0].kinds[0]
    toks = torch.as_tensor(np.random.default_rng(MESH_SEED).integers(
        0, cfg.vocab, (n_micro, 1, S), dtype=np.int32), device=dev)
    x = model._embed(params, toks.reshape(n_micro, S)).reshape(
        n_micro, 1, S, -1)
    positions = torch.arange(S, device=dev)[None]

    def stage(p, h):
        for j in range(per):
            h, _ = T._apply_layer(cfg, kind, tree_map(lambda t: t[j], p), h,
                                  positions=positions, mode="prefill",
                                  cache=None)
        return h
    mesh = make_mesh((MESH_RANKS,), ("stage",))
    mine = tree_map(lambda t: t[rank * per:(rank + 1) * per][None], layers)
    comm.reset_counters()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = gpipe(stage, mine, x, mesh)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        out = {"pipe_s": pipe_s, "bytes": comm.counters()}
        if rank == 0:
            t0 = time.perf_counter()
            seq = []
            for m in range(n_micro):
                h = x[m]
                for s in range(MESH_RANKS):
                    h = stage(tree_map(lambda t: t[s * per:(s + 1) * per],
                                       layers), h)
                seq.append(h)
            seq = torch.stack(seq)
            torch.cuda.synchronize()
            out["sequential_s"] = time.perf_counter() - t0
            same = torch.equal(y.view(torch.int16), seq.view(torch.int16))
            out["bit_equal"] = bool(same)
            out["max_abs_err"] = float((y.float() - seq.float()).abs().max())
            out["finite"] = bool(torch.isfinite(y).all())
    del model, params, layers, x
    torch.cuda.empty_cache()
    return out


def mesh_phases_rank(rank, go_file: str, tmp: str) -> dict:
    """The mesh job: every rank waits for ``go_file`` (the main process
    writes it once ``train_dlrm`` has freed the card), then the four
    phases one after another; rank 0 also runs the single-process sides.
    Returns this rank's numbers by phase."""
    import torch
    from repro_torch.common import comm
    from repro_torch.launch.mesh import rank_device
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    tmp = Path(tmp)
    while not Path(go_file).exists():
        time.sleep(0.1)
    t_go = time.perf_counter()
    out = {}
    # ---- mesh_dlrm --------------------------------------------------------
    single = None
    if rank == 0:
        from repro_torch.configs import get_config
        from repro_torch.configs.base import TrainConfig
        from repro_torch.data import dlrm_batch
        cfg = get_config("dlrm")
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                    dlrm_batch(0, i, MESH_DLRM_BATCH, cfg).items()}
                   for i in range(MESH_DLRM_STEPS)]
        t0 = time.perf_counter()
        single = mesh_dlrm_single(cfg, TrainConfig(), batches, dev)
        # the control: one process whose step-1 MLP gradient is perturbed
        # by MESH_DLRM_PERTURB, about what the mesh's bf16 partial sums
        # give it: how far 3 sound steps part from such a start
        single["control"] = mesh_dlrm_single(
            cfg, TrainConfig(), batches, dev, faults=False,
            perturb=MESH_DLRM_PERTURB)
        single["seconds"] = time.perf_counter() - t0
        del batches
        mesh_log(rank, f"mesh_dlrm single process {single['seconds']:.1f} s")
    comm.barrier()
    t0 = time.perf_counter()
    out["mesh_dlrm"] = mesh_dlrm_rank(rank, dev, single)
    out["mesh_dlrm"]["seconds"] = time.perf_counter() - t0
    if single is not None:
        out["mesh_dlrm"]["single_seconds"] = single["seconds"]
    del single
    torch.cuda.empty_cache()
    # ---- mesh_elastic -----------------------------------------------------
    t0 = time.perf_counter()
    out["mesh_elastic"] = mesh_elastic_rank(rank, dev, tmp)
    out["mesh_elastic"]["seconds"] = time.perf_counter() - t0
    # ---- mesh_moe ---------------------------------------------------------
    t0 = time.perf_counter()
    ref = mesh_moe_single(dev) if rank == 0 else None
    comm.barrier()
    out["mesh_moe"] = mesh_moe_rank(rank, dev)
    if ref is not None:
        out["mesh_moe"]["single"] = ref
    out["mesh_moe"]["seconds"] = time.perf_counter() - t0
    comm.barrier()
    # ---- mesh_gpipe -------------------------------------------------------
    t0 = time.perf_counter()
    out["mesh_gpipe"] = mesh_gpipe_rank(rank, dev)
    out["mesh_gpipe"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_go
    mesh_log(rank, f"mesh phases done in {out['seconds']:.1f} s")
    return out


def start_mesh_job(tmp: Path):
    """The mesh job's ranks, started now on the card (``MESH_RANKS``
    processes sharing ``cuda:0`` over gloo); they wait for the go file."""
    from repro_torch.launch.mesh import RankJob
    go = tmp / "mesh_go"
    job = RankJob(mesh_phases_rank, MESH_RANKS,
                  devices=["cuda:0"] * MESH_RANKS,
                  args=(str(go), str(tmp)), timeout_s=MESH_GROUP_TIMEOUT_S,
                  tmpdir=str(tmp / "mesh_rdv"))
    return job, go


def _over(reading: float, limit: float) -> bool:
    return not reading <= limit


def mesh_phases(gpu: str, job) -> dict:
    """Phase 7d in the main process: joins the mesh job (let go once the
    card is free of ``train_dlrm``), prints ``mesh_dlrm``,
    ``mesh_elastic``, ``mesh_moe`` and ``mesh_gpipe`` and holds their
    numbers (the DLRM's against ``MESH_DLRM_TOL``, each limit also below
    its planted faults' readings of this run).  Returns the bag kernels'
    launches on the mesh path (every rank's, ``mesh_dlrm``'s 3 steps)."""
    t0 = time.perf_counter()
    res = job.join(MESH_JOIN_S)
    wall = time.perf_counter() - t0
    r0 = res[0]
    tol = MESH_DLRM_TOL
    # ---- mesh_dlrm ----------------------------------------------------------
    d0 = r0["mesh_dlrm"]
    single = d0["single"]
    for r in res:
        d = r["mesh_dlrm"]
        if d["losses"] != d0["losses"] or d["grad_norms"] != d0["grad_norms"]:
            raise AssertionError(f"mesh_dlrm: ranks read different metrics "
                                 f"{d['losses']} vs {d0['losses']}")
        if d["launches"] != {"embedding_bag_rows": MESH_DLRM_STEPS,
                             "embedding_bag_backward": MESH_DLRM_STEPS}:
            raise AssertionError(f"mesh_dlrm: rank launches {d['launches']}")
    keys = ("touched_rows", "step1_loss_diff", "loss_diffs", "norm_rels",
            "grad1_rel", "update_rel", "moments_rel", "params_max_abs_diff",
            "p0_bit_equal", "tables_untouched_bit_equal", "grad_fn_loss",
            "planted", "control", "dlrm_comm_spec", "comm_profile")
    line = {"phase": "mesh_dlrm", "gpu": gpu, "transport": d0["transport"],
            "ranks": MESH_RANKS, "mesh": {"data": MESH_RANKS},
            "tables_over": "data", "batch": MESH_DLRM_BATCH,
            "rows_a_rank": MESH_DLRM_BATCH // MESH_RANKS,
            "losses": d0["losses"], "grad_norms": d0["grad_norms"],
            "single_process": single, "step_s": d0["step_s"],
            "peak_bytes_by_rank": [r["mesh_dlrm"]["peak_bytes"] for r in res],
            "launches_by_rank": [r["mesh_dlrm"]["launches"] for r in res],
            "bytes_per_step_by_rank": [r["mesh_dlrm"]["bytes_per_step"][-1]
                                       for r in res],
            **{k: d0[k] for k in keys},
            "bags_check_by_rank": [r["mesh_dlrm"]["bags_check"] for r in res],
            "tolerance": tol, "single_seconds": d0["single_seconds"],
            "seconds": d0["seconds"]}
    emit(line)
    if not all(math.isfinite(x) for x in d0["losses"] + d0["grad_norms"]):
        raise AssertionError(f"mesh_dlrm: non-finite {line}")
    for r in res:
        c = r["mesh_dlrm"]["bags_check"]
        if c["forward_differing"] or c["backward_differing"]:
            raise AssertionError(f"mesh_dlrm: a bag kernel at the rank's "
                                 f"shapes differs from its plain version: {c}")
    if not (d0["p0_bit_equal"] and d0["tables_untouched_bit_equal"]):
        raise AssertionError("mesh_dlrm: the initial weights or the "
                             "untouched rows differ from one process's")
    for f, p in d0["planted"].items():
        if not (_over(p["step1_loss_diff"], tol["loss1"])
                and _over(p["grad1_rel"]["tables"], tol["grad1"])
                and _over(p["grad1_rel"]["mlp"], tol["grad1"])):
            raise AssertionError(f"mesh_dlrm: the limits {tol} do not "
                                 f"separate the planted fault {f}: {p}")
    readings = [("step 1's loss", d0["step1_loss_diff"], tol["loss1"]),
                ("step 1's norm", d0["norm_rels"][0], tol["norm1"])]
    readings += [(f"step {i + 1}'s loss", x, tol["loss"])
                 for i, x in enumerate(d0["loss_diffs"])]
    readings += [(f"step {i + 1}'s norm", x, tol["norm"])
                 for i, x in enumerate(d0["norm_rels"])]
    for k in ("tables", "mlp"):
        readings += [(f"step 1's gradient ({k})", d0["grad1_rel"][k],
                      tol["grad1"]),
                     (f"the update ({k})", d0["update_rel"][k],
                      tol["update"])]
        readings += [(f"the final {m} ({k})", d0["moments_rel"][m][k],
                      tol["moments"]) for m in ("mu", "nu")]
    for what, x, limit in readings:
        if _over(x, limit):
            raise AssertionError(f"mesh_dlrm: {what} lies {x} from one "
                                 f"process's (limit {limit})")
    # ---- mesh_elastic -------------------------------------------------------
    e0 = r0["mesh_elastic"]
    keys = ("ckpt_bytes", "leaves", "restore_one_s", "restore_two_s",
            "restored_bit_equal", "restored_two_bit_equal", "step4_four",
            "step4_two", "step4_loss_diff", "step4_norm_rel",
            "step4_grad_rel", "planted_blocks_swapped_rel")
    line = {"phase": "mesh_elastic", "gpu": gpu, "transport": d0["transport"],
            "rows_per_table": MESH_ELASTIC_ROWS,
            "saved_on": {"data": MESH_RANKS}, "restored_onto": [
                "one process", {"data": 2}],
            "losses": e0["losses"], "step_s": e0["step_s"],
            "save_s": [r["mesh_elastic"]["save_s"] for r in res],
            **{k: e0[k] for k in keys},
            "bags_check_by_rank": [r["mesh_elastic"]["bags_check_two"]
                                   for r in res[:2]],
            "tolerance": {"restore": "bit for bit", "step 4 on 2 ranks":
                          {k: tol[k] for k in ("loss1", "norm1", "grad1")}},
            "seconds": e0["seconds"]}
    emit(line)
    if e0["meta"] != {"next_step": MESH_DLRM_STEPS}:
        raise AssertionError(f"mesh_elastic: meta {e0['meta']}")
    if not (e0["restored_bit_equal"] and e0["restored_two_bit_equal"]):
        raise AssertionError("mesh_elastic: a restored block differs")
    for c in line["bags_check_by_rank"]:
        if c["forward_differing"] or c["backward_differing"]:
            raise AssertionError(f"mesh_elastic: a bag kernel at the rank's "
                                 f"shapes differs from its plain version: {c}")
    if not _over(e0["planted_blocks_swapped_rel"], tol["grad1"]):
        raise AssertionError(f"mesh_elastic: the limit {tol['grad1']} does "
                             "not separate the swapped blocks")
    for what, x, limit in (
            ("loss", e0["step4_loss_diff"], tol["loss1"]),
            ("norm", e0["step4_norm_rel"], tol["norm1"]),
            ("gradient (tables)", e0["step4_grad_rel"]["tables"],
             tol["grad1"]),
            ("gradient (mlp)", e0["step4_grad_rel"]["mlp"], tol["grad1"])):
        if _over(x, limit):
            raise AssertionError(f"mesh_elastic: step 4's {what} on 2 ranks "
                                 f"lies {x} from 4 ranks' (limit {limit})")
    # ---- mesh_moe -----------------------------------------------------------
    m0 = r0["mesh_moe"]
    ref = m0["single"]
    rows_out = {}
    for shape, impl in MESH_MOE_CASES:
        case = f"{impl}_{shape[0]}x{shape[1]}"
        row = {"mesh": dict(zip(("data", "model"), shape)), "impl": impl}
        for dt in ("f32", "bf16"):
            logits = np.zeros_like(ref[dt]["logits"])
            experts = np.zeros_like(ref[dt]["experts"])
            for r in res:
                c = r["mesh_moe"][case]
                lo, hi = c["rows"]
                logits[lo:hi] = c[dt]["logits"]
                experts[lo:hi] = c[dt]["experts"]
            # the MoE layer is the last: a row's last logits depend on its
            # last token's experts alone
            alike = (experts[:, -1] == ref[dt]["experts"][:, -1]).all(-1)
            want = ref[dt]["logits"]
            err = float(np.linalg.norm(logits[alike] - want[alike])
                        / max(np.linalg.norm(want[alike]), 1e-30)) \
                if alike.any() else float("nan")
            row[dt] = {"rel_l2": err, "rows_alike": [int(alike.sum()),
                                                     len(alike)],
                       "dropped": sum(r["mesh_moe"][case][dt]["dropped"]
                                      for r in res),
                       "prefill_s": max(r["mesh_moe"][case][dt]["s"]
                                        for r in res),
                       "single_prefill_s": ref[dt]["s"]}
        row["all_to_all_bytes_by_rank"] = [
            r["mesh_moe"][case]["f32"]["bytes"]["all_to_all"] for r in res]
        row["psum_bytes_by_rank"] = [
            r["mesh_moe"][case]["f32"]["bytes"]["psum"] for r in res]
        rows_out[case] = row
    line = {"phase": "mesh_moe", "gpu": gpu, "transport": d0["transport"],
            "arch": "deepseek-v2-236b", "layers": 2,
            "rows": MESH_MOE_ROWS, "seq": MESH_MOE_SEQ,
            "capacity_factor": MESH_MOE_CAPACITY, "cases": rows_out,
            "tolerance": f"f32 rel. L2 {MESH_MOE_TOL} over the rows whose "
                         "last token routed alike (at least half); bf16 "
                         "reported", "seconds": m0["seconds"]}
    emit(line)
    for case, row in rows_out.items():
        for dt in ("f32", "bf16"):
            if row[dt]["dropped"]:
                raise AssertionError(f"mesh_moe {case}: {row[dt]['dropped']} "
                                     "slots dropped")
        n, total = row["f32"]["rows_alike"]
        if 2 * n < total or not row["f32"]["rel_l2"] <= MESH_MOE_TOL:
            raise AssertionError(f"mesh_moe {case}: {row['f32']}")
    # ---- mesh_gpipe ---------------------------------------------------------
    g0 = r0["mesh_gpipe"]
    n_layers, per, n_micro, S = MESH_GPIPE
    line = {"phase": "mesh_gpipe", "gpu": gpu, "transport": d0["transport"],
            "arch": "tinyllama-1.1b", "layers": n_layers,
            "layers_a_stage": per, "stages": MESH_RANKS,
            "microbatches": n_micro, "tokens_a_microbatch": S,
            "bit_equal": g0["bit_equal"], "max_abs_err": g0["max_abs_err"],
            "pipe_s": [r["mesh_gpipe"]["pipe_s"] for r in res],
            "sequential_s": g0["sequential_s"],
            "ppermute_bytes_by_rank": [r["mesh_gpipe"]["bytes"]["ppermute"]
                                       for r in res],
            "seconds": g0["seconds"]}
    emit(line)
    if not (g0["bit_equal"] and g0["finite"]):
        raise AssertionError(f"mesh_gpipe: {line}")
    emit({"phase": "mesh_job", "gpu": gpu, "wall_s": wall,
          "ranks_s": [r["seconds"] for r in res]})
    return {k: sum(r["mesh_dlrm"]["launches"][k] for r in res)
            for k in ("embedding_bag_rows", "embedding_bag_backward")}


def flash_grad_check(q, k, v, block: int) -> dict:
    """``flash_attention``'s q/k/v gradients against autograd through
    ``layers.blockwise_attention`` (no wedge split: plain tiles) on
    captured inputs in float32, for a random upstream gradient: each
    within rtol 1e-4 of its largest magnitude."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.flash import flash_attention
    ins = [t.detach().float() for t in (q, k, v)]
    w = torch.randn(q.shape, generator=torch.Generator(
        device=q.device).manual_seed(0), device=q.device)
    grads = []
    for attn in (lambda a, b, c: flash_attention(a, b, c, True, block, block),
                 lambda a, b, c: L.blockwise_attention(
                     a, b, c, causal=True, block_q=block, block_k=block,
                     split_wedge=False)):
        xs = [t.clone().requires_grad_() for t in ins]
        out = attn(*xs)
        grads.append((out.detach(), torch.autograd.grad((out * w).sum(), xs)))
        del out, xs
    (o1, g1), (o2, g2) = grads
    err = {"out": float((o1 - o2).abs().max() / o2.abs().max())}
    err.update({n: float((a - b).abs().max() / b.abs().max())
                for n, a, b in zip("qkv", g1, g2)})
    out = {"shape": list(q.shape), "block": block, "rel_err": err,
           "tolerance": "rtol 1e-4 of each gradient's largest magnitude"}
    if max(err.values()) > 1e-4:
        raise AssertionError(f"flash_grad_check: {out}")
    return out


class capture_flash:
    """While active, keeps the first call's (q, k, v) of
    ``transformer.flash_attention`` (detached) and counts the calls."""

    def __enter__(self):
        from repro_torch.models import transformer as T
        self.mod, self.orig, self.first, self.calls = T, T.flash_attention, \
            None, 0

        def wrapped(q, k, v, *a, **kw):
            if self.first is None:
                self.first = tuple(t.detach().clone() for t in (q, k, v))
            self.calls += 1
            return self.orig(q, k, v, *a, **kw)
        T.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.orig


def lm_train_run(model, tcfg, batches, dev) -> dict:
    """``len(batches)`` AdamW steps of ``model`` from parameters drawn from
    seed 0 on the card: losses, norms, wall s a step, peak bytes and the
    digest of the parameters, master copy and moments."""
    import torch
    from repro_torch.train.train_step import init_train_state, make_train_step
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), tcfg)
    step = make_train_step(model, tcfg)
    losses, norms, secs = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms, "step_s": secs,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "digest": tree_digest((params, opt))}
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def nondeterministic_leaves(model, batch, dev) -> list:
    """The parameter leaves whose gradient differs between two
    computations on the same parameters and batch."""
    import torch
    from repro_torch.train.train_step import make_grad_fn
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    grad_fn = make_grad_fn(model)
    _, g1 = grad_fn(params, batch)
    d1 = tree_digest(g1)
    del g1
    _, g2 = grad_fn(params, batch)
    d2 = tree_digest(g2)
    return [k for k in d1 if d1[k] != d2[k]]


def train_tinyllama(gpu: str, dev) -> None:
    """TinyLlama-1.1B at full width and depth with ``flash_attention`` on
    (``Model.init`` on the card, seed 0), ``lm_batch`` at 8 x 2,048 (past
    the dense cutoff: flash attention), ``TrainConfig`` defaults with
    ``microbatch=4``: three AdamW steps, twice.  Finite losses and norms;
    step 1's loss equal to the cross-entropy of
    ``prefill(all_logits=True)`` on its tokens at bf16's tolerance (one
    ulp relative); flash attention's gradient against blockwise
    attention's on layer 0's captured q/k/v (``flash_grad_check``).
    Whether the two runs repeat bit for bit is reported, with the leaves
    whose gradient does not repeat where they do not."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              flash_attention=True)
    model = Model(cfg, device=dev)
    tcfg = TrainConfig(microbatch=4)
    B, S = 8, 2048
    batches = [{"tokens": torch.as_tensor(lm_batch(0, i, B, S, cfg.vocab)
                                          ["tokens"], device=dev)}
               for i in range(3)]
    t0 = time.perf_counter()
    # the teacher-forced cross-entropy of the initial weights, and layer
    # 0's attention inputs
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tok = batches[0]["tokens"]
    with torch.no_grad(), capture_flash() as cap:
        logits, _ = model.prefill(params, batches[0], all_logits=True)
        ce = float(F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab),
                                   tok[:, 1:].reshape(-1).long()))
    del logits, params
    torch.cuda.empty_cache()
    flash = flash_grad_check(*(t[:2] for t in cap.first), cfg.block_q)
    flash["prefill_calls"] = cap.calls
    del cap
    a = lm_train_run(model, tcfg, batches, dev)
    b = lm_train_run(model, tcfg, batches, dev)
    repeat = a["digest"] == b["digest"] and a["losses"] == b["losses"]
    line = {"phase": "train_tinyllama", "gpu": gpu, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": B, "seq": S,
            "microbatch": tcfg.microbatch, "losses": a["losses"],
            "grad_norms": a["grad_norms"], "prefill_cross_entropy": ce,
            "step_s": a["step_s"], "repeat_step_s": b["step_s"],
            "tokens_per_s": B * S / statistics.median(a["step_s"]),
            "peak_bytes": a["peak_bytes"], "repeat_equal": repeat,
            "flash_grad_check": flash}
    if not repeat:
        line["nondeterministic_leaves"] = nondeterministic_leaves(
            model, {"tokens": tok[:tcfg.microbatch]}, dev)
        line["repeat_differing_leaves"] = [
            k for k in a["digest"] if a["digest"][k] != b["digest"][k]]
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not all(math.isfinite(x) for x in a["losses"] + a["grad_norms"]):
        raise AssertionError(f"train_tinyllama: non-finite {line}")
    if abs(a["losses"][0] - ce) > 2 ** -8 * abs(ce):
        raise AssertionError(f"train_tinyllama: step 1's loss "
                             f"{a['losses'][0]} vs the prefill's "
                             f"cross-entropy {ce}")
    if flash["prefill_calls"] != cfg.n_layers:
        raise AssertionError(f"train_tinyllama: {flash['prefill_calls']} "
                             f"flash calls for {cfg.n_layers} layers")


def train_reference(gpu: str, dev) -> None:
    """``TRAIN_REF``'s runs on the card: the smoke TinyLlama and DLRM with
    float32 activations and ``TRAIN_REF_SEED``'s numpy weights, three
    AdamW steps (the DLRM's bags through both kernels); each step's loss
    and gradient norm within ``TRAIN_REF_RTOL`` of the JAX reference's."""
    import torch
    from repro_torch import convert
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import dlrm_batch, lm_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import DLRM, Model, param_shapes
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step
    rows = {}
    for name, want in TRAIN_REF.items():
        cfg = smoke_config(name)
        if name == "dlrm":
            shapes = param_shapes(cfg)
            tree = dlrm_numpy_params(
                {"tables": shapes["tables"][0],
                 **{part: {k: leaf[0] for k, leaf in shapes[part].items()}
                    for part in ("bot", "top")}}, TRAIN_REF_SEED)
            params = {"tables": torch.from_numpy(tree["tables"].view(
                np.int16)).view(torch.bfloat16).to(dev),
                **{part: {k: torch.from_numpy(v).to(dev)
                          for k, v in tree[part].items()}
                   for part in ("bot", "top")}}
            model = DLRM(cfg, device=dev, params=params)
            params = model.param_tree()
        else:
            model = Model(cfg, device=dev)
            shapes = tree_map(lambda d: d.shape, model.param_defs())
            params = convert.transformer_params_from_numpy(
                transformer_numpy_params(shapes, TRAIN_REF_SEED, bf16=False),
                dev)
        model.compute_dtype = torch.float32
        opt = init_opt_state(params, torch.float32, keep_master=False)
        step = make_train_step(model, TrainConfig(**TRAIN_REF_TCFG))
        ops.reset_launches()
        losses, norms = [], []
        for i in range(TRAIN_REF_STEPS):
            b = (dlrm_batch(TRAIN_REF_SEED, i, TRAIN_REF_BATCH[name], cfg)
                 if name == "dlrm" else
                 lm_batch(TRAIN_REF_SEED, i, *TRAIN_REF_BATCH[name],
                          cfg.vocab))
            params, opt, m = step(params, opt, {
                k: torch.as_tensor(v, device=dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        err = max(abs(g - w) / abs(w) for g, w in zip(
            losses + norms, want["loss"] + want["grad_norm"]))
        rows[name] = {"losses": losses, "grad_norms": norms,
                      "max_rel_err": err, "launches": dict(ops.LAUNCHES)}
    out = {"phase": "train_reference", "gpu": gpu, "rows": rows,
           "tolerance": f"rtol {TRAIN_REF_RTOL}"}
    emit(out)
    if any(r["max_rel_err"] > TRAIN_REF_RTOL for r in rows.values()):
        raise AssertionError(f"train_reference: off the reference: {out}")


TRAIN_ENTRY_ARGS = ("--smoke", "--steps", "8", "--ckpt-every", "2")
TRAIN_ENTRY_FAIL_AT = 5


def start_train_entry(tmp: Path) -> tuple:
    """Start ``train_entry``'s runs (``finish_train_entry`` checks them):
    ``python -m repro_torch.launch.train`` in child processes, all at
    once (as ``serve_entry`` drives ``launch.serve``'s entry point, but
    in processes of their own: a run restarts from its checkpoint
    directory): ``--arch tinyllama-1.1b`` and ``--arch dlrm`` with
    ``TRAIN_ENTRY_ARGS``, each with ``--fail-at 5`` and without, each
    against a fresh ``--ckpt-dir``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    tmp.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for arch in ("tinyllama-1.1b", "dlrm"):
        for cut in (True, False):
            tag = f"{arch}_{'cut' if cut else 'full'}"
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", arch, *TRAIN_ENTRY_ARGS, "--ckpt-dir",
                   str(tmp / tag), "--metrics-out", str(tmp / f"{tag}.jsonl")]
            if cut:
                cmd += ["--fail-at", str(TRAIN_ENTRY_FAIL_AT)]
            procs[tag] = subprocess.Popen(cmd, env=env, cwd=str(REPO),
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)
    return procs, t0


def finish_train_entry(gpu: str, tmp: Path, procs: dict, t0: float) -> None:
    """Wait for ``start_train_entry``'s runs: the cut runs must print
    ``restarts=1``, and their metrics logs, the re-run steps taken once,
    must equal the uninterrupted runs' bit for bit."""
    outs = {}
    try:
        for tag, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"train_entry {tag}: exit "
                                     f"{proc.returncode}: {stderr[-3000:]}")
            last = stdout.strip().splitlines()[-1]
            outs[tag] = {"line": last, "fields": dict(
                kv.split("=") for kv in last.split()),
                "log": [json.loads(x) for x in
                        (tmp / f"{tag}.jsonl").read_text().splitlines()]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rows = {}
    for arch in ("tinyllama-1.1b", "dlrm"):
        cut, full = outs[f"{arch}_cut"], outs[f"{arch}_full"]
        resumed = {m["step"]: m for m in cut["log"]}
        rows[arch] = {"cut": cut["line"], "full": full["line"],
                      "steps_logged": len(cut["log"]),
                      "log_equal": [resumed[s] for s in sorted(resumed)]
                      == full["log"]}
        if cut["fields"]["restarts"] != "1" or full["fields"][
                "restarts"] != "0" or not rows[arch]["log_equal"]:
            raise AssertionError(f"train_entry {arch}: {rows[arch]}")
    emit({"phase": "train_entry", "gpu": gpu, "args": list(TRAIN_ENTRY_ARGS),
          "fail_at": TRAIN_ENTRY_FAIL_AT, "rows": rows,
          "seconds": time.perf_counter() - t0})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import ScenarioSpec
    from repro_torch.kernels import build
    from repro_torch.kernels.engine_step import ops

    # ---- 1. build (one nvcc per source, all at once) ----------------------
    # the child phases start once every source but flash_decode (the
    # longest build, first needed in phase 10) is built
    gpu = gpu_line()
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(build.SOURCES))
    builds = {name: pool.submit(build.build, name) for name in build.SOURCES}
    for name in build.SOURCES:
        if name != "flash_decode":
            builds[name].result()
            build.load(name)
    engine_built = time.perf_counter() - t0
    # every fused_signals_policy_kernel<N>: registers, spills, SASS
    # instructions and asynchronous copies; each must copy asynchronously
    fused_sass = sass_counts(build.build("engine_step"))
    for k, v in fused_sass.items():
        if k.startswith("fused_signals_policy_kernel") and \
                not v["LDGSTS"] + v["UBLKCP"] + v["UTMALDG"]:
            raise AssertionError(f"{k}: no asynchronous copy in its SASS")

    import tempfile
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    os.environ["REPRO_CACHE_DIR"] = str(tmp / "cache")
    procs = start_child_phases(tmp, CHILD_PHASES)
    try:
        runner = main_runner()
        cfg = runner.cfg
        scen = main_scenarios()
        sims = {}
        for label, (fab, wl) in scen.items():
            topo, sched, pol = ScenarioSpec(fab, wl, "dcqcn").build()
            sims[label] = runner.simulator(topo, sched, pol)
        sims["fig12"] = runner.simulator(*fig12_scenario())

        # ---- 2. kernels against their plain versions (timed in phase 5q,
        # once the child phases are done) -----------------------------------
        # at every padded flow count and plan of the main paths, B in
        # CHECK_LANES
        flows = sorted(set(FUSED_EDGE_FLOWS)
                       | {s.plan.n_flows_pad for s in sims.values()})
        fused = check_fused(dev, flows)
        emit({"phase": "kernel_check", "kernel": "fused_signals_policy",
              **fused})
        # the policies' scalar device functions over every float32 input
        scalar = scalar_exhaustive(ops.kernel_function("scalar_fn"))
        emit({"phase": "scalar_exhaustive", "gpu": gpu, **scalar})
        for name, r in scalar.items():
            if r["mismatches"]:
                raise AssertionError(f"scalar_fn {name}: {r['mismatches']} "
                                     f"inputs differ from arith.{name}: "
                                     f"{r['first']}")
        plans = gather_plans(sims)
        seg_err, seg_rows = check_segments(plans, dev)
        emit({"phase": "kernel_check", "kernel": "segment_reduce(+_pfc)",
              "plans": seg_rows, "lanes": list(CHECK_LANES),
              "max_abs_err": seg_err,
              "tolerance": "bit-equal sums; paused equal everywhere"})
        emit({"phase": "batched_step_check",
              **check_batched_step(sims["fig12"], cfg)})
        ccu_check = check_cc_update(dev)
        emit({"phase": "cc_update_check", "kernel": "dcqcn_update",
              **ccu_check})

        builds["flash_decode"].result()
        pool.shutdown()
        build.load("flash_decode")
        info = build.BUILD_INFO
        ptxas = {k: ptxas_summary(v.get("ptxas", "")) for k, v in info.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "engine_seconds": engine_built,
              "sources": {k: v.get("seconds") for k, v in info.items()},
              "nvcc": next(iter(info.values()), {}).get("nvcc"), "gpu": gpu,
              "ptxas": ptxas, "fused_sass": {
                  k: dict(v, ptxas=ptxas.get("engine_step", {}).get(k))
                  for k, v in fused_sass.items()
                  if k.startswith("fused_signals_policy_kernel")},
              "flash_decode_sass": sass_counts(build.build("flash_decode"))})

        # (2b, the backend calibration, is a child phase: its probes are
        # wall-clock times under contention; the ladder and prediction
        # phases' child waits for its table on disk)
        return main_paths(dev, gpu, t_start, runner, cfg, scen, sims,
                          fused, seg_err, ccu_check, procs, tmp)
    finally:
        stop_processes(procs)
        tmp_dir.cleanup()


def main_paths(dev, gpu, t_start, runner, cfg, scen, sims, fused, seg_err,
               ccu_check, procs, tmp) -> int:
    """Phases 3-14 and the result lines (``main``'s second half), with
    phase 13m's ``launch.train`` runs beside them until the join."""
    entry_procs, entry_t0 = start_train_entry(tmp / "train_entry")
    try:
        return main_sims(dev, gpu, t_start, runner, cfg, scen, sims, fused,
                         seg_err, ccu_check, procs, tmp, entry_procs,
                         entry_t0)
    finally:
        for proc in entry_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main_sims(dev, gpu, t_start, runner, cfg, scen, sims, fused, seg_err,
              ccu_check, procs, tmp, entry_procs, entry_t0) -> int:
    """Phases 3-5m in the main process, then ``main_tail``."""
    from repro_torch.core import ScenarioSpec
    from repro_torch.kernels.engine_step import ops
    s128, s32 = sims["clos128_1d"], sims["clos32_2d"]

    # ---- 3. main path at the paper's scale ---------------------------------
    # (pfc and hpcc run at this scale in the policy-axis child's batch and
    # mlp in the mlp_clos128 child, each against the reference)
    ops.reset_launches()
    results = {}
    for pol in ("dcqcn",):
        fab, wl = scen["clos128_1d"]
        r, launches = run_main(runner, ScenarioSpec(fab, wl, pol),
                               "clos128_1d", "cuda")
        # per executed step: one fused launch, one segment_reduce for
        # each non-empty plan but qport (gather and split-row alike) and
        # one for the soft cost, one segment_reduce_pfc for qport
        steps = r.meta["steps_executed"]
        seg, pfc = segment_launches(s128.plan)
        if (launches["fused_signals_policy"], launches["segment_reduce"],
                launches["segment_reduce_pfc"]) != (steps, seg * steps,
                                                    pfc * steps):
            raise AssertionError(f"clos128_1d {pol}: {launches} launches "
                                 f"for {steps} executed steps ({seg} "
                                 f"segment_reduce, {pfc} segment_reduce_pfc "
                                 "a step)")
        results[("clos128_1d", pol)] = r
    # the 128-GPU op-path side of the kernel-vs-op-path check is the dcqcn
    # lane of the policy-axis child's batch: it gets this run
    r = results[("clos128_1d", "dcqcn")]
    np.savez(tmp / "clos128_dcqcn.npz", finished=r.finished,
             completion_time=r.completion_time,
             **{k: np.asarray(getattr(r, k))
                for k in ("t_finish", "delivered", "pause_count")})
    send_child(procs, tmp, "policy_axis", str(tmp / "clos128_dcqcn.npz"))

    # ---- 4. main path where all three kernels run ---------------------------
    fab, wl = scen["clos32_2d"]
    r_k, l_k = run_main(runner, ScenarioSpec(fab, wl, "dcqcn"), "clos32_2d",
                        "cuda")
    steps = r_k.meta["steps_executed"]
    seg, pfc = segment_launches(s32.plan)
    if (l_k["fused_signals_policy"], l_k["segment_reduce"],
            l_k["segment_reduce_pfc"]) != (steps, seg * steps, pfc * steps):
        raise AssertionError(f"clos32_2d: {l_k} launches for {steps} "
                             f"executed steps ({seg} segment_reduce, {pfc} "
                             "segment_reduce_pfc a step)")
    r_t, l_t = run_main(runner, ScenarioSpec(fab, wl, "dcqcn"), "clos32_2d",
                        "torch")
    if any(l_t.values()):
        raise AssertionError(f"op path launched kernels: {l_t}")
    results[("clos32_2d", "dcqcn")] = r_k
    emit({"phase": "kernel_vs_op_path", "scenario": "clos32_2d",
          "policy": "dcqcn", **compare_runs(r_k, r_t, DT, "clos32_2d dcqcn")})
    main_launches = dict(ops.LAUNCHES)
    # soft_grad's children hold their gradients' values to these runs' costs
    forward = json.dumps({
        label: {"soft_cost": results[label, "dcqcn"].soft_cost,
                "steps_executed": results[label, "dcqcn"].meta[
                    "steps_executed"]}
        for label in ("clos128_1d", "clos32_2d")})
    for name in ("soft_grad", "soft_grad128"):
        send_child(procs, tmp, name, forward)

    # ---- 5. against the JAX reference ---------------------------------------
    rows = []
    for key, want in REFERENCE.items():
        if key not in results:           # held in the policy-axis child
            continue
        got = results[key].completion_time
        diff = float(steps_apart(got, want, DT))
        rows.append({"scenario": key[0], "policy": key[1], "port": got,
                     "reference": want, "diff_steps": diff})
        if diff > 2:
            raise AssertionError(f"{key}: completion {got} vs reference "
                                 f"{want} ({diff:.2f} steps)")
    emit({"phase": "reference", "tolerance_steps": 2, "rows": rows})

    # ---- 5b. the DCQCN update through its entry point ----------------------
    ccu_launches, ccu_path = cc_update_path(dev)
    emit({"phase": "cc_update_path", "gpu": gpu, **ccu_path})

    # ---- 5c-5d, 5f, 5h run in child phases: Fig 12's 9 lanes as one batch
    # and over a mesh of the card (fig12_lanes), the policy comparison as
    # one policy-axis batch (op path), Fig 13's fault lanes as one batch
    # and the learned policy at paper scale, lossless and lossy ----------

    # ---- 5e. the faulty step under mlp, kernel vs op path, paper scale -----
    emit({"phase": "lossy_step_check", **lossy_step_check(runner)})

    # ---- 5g. every engine kernel under loss, ECN scale and degradation -----
    f32_launches = faults_clos32(runner, scen, gpu)

    # ---- 5i. the held-out incast, all eight policies (op path) ------------
    mlp_heldout16(gpu)

    # ---- 9. DLRM: the training iteration under each policy ------------------
    iter_launches = dlrm_iteration(cfg, gpu)

    # ---- 5m. the atlas campaign, resumed from the killed child's journal --
    child = finish_child_phases(procs, tmp, ("campaign_atlas128_kill",))
    atlas_launches = campaign_atlas128(gpu, tmp / "atlas",
                                       child["campaign_atlas128_kill"])

    return main_tail(dev, gpu, t_start, cfg, sims, fused, seg_err,
                     ccu_check, procs, tmp, child, main_launches,
                     ccu_launches, f32_launches, iter_launches,
                     atlas_launches, entry_procs, entry_t0)


def main_tail(dev, gpu, t_start, cfg, sims, fused, seg_err, ccu_check,
              procs, tmp, child, main_launches, ccu_launches,
              f32_launches, iter_launches, atlas_launches, entry_procs,
              entry_t0) -> int:
    """Phases 5j-14 and the result lines: the child phases' lines and
    ``launch.train``'s runs, then, with nothing beside the main process,
    the kernels' times and the DLRM, serving and training phases."""
    import torch
    s128 = sims["clos128_1d"]

    # ---- 5j-5p end: the child phases' lines ------------------------------
    child.update(finish_child_phases(procs, tmp, list(procs)))
    calibration = child["calibrate"]["record"]
    if child["calibrate_warm_start"]["record"] != calibration:
        raise AssertionError("calibrate_warm_start: the child's table "
                             f"{child['calibrate_warm_start']} differs from "
                             f"phase 2b's {calibration}")
    fig12_launches = child["batch_fig12"]["launches"]
    mesh_launches = child["mesh_lanes"]["launches"]
    fault_launches = child["fault_grid_dcqcn"]["launches"]
    mlp_launches = child["mlp_clos128"]["launches"]
    finish_train_entry(gpu, tmp / "train_entry", entry_procs, entry_t0)

    # ---- 5q. the engine kernels' times (phase 2's kernels) -----------------
    traced = {}          # kernel row -> its timed calls, for phase 14
    timing = {"fused_signals_policy": time_fused(s128, sims["fig12"], dev,
                                                 traced)}
    for name, prefix, label, what in SEGMENT_TIMED:
        key = name + (f"/{prefix[:-1]}" if prefix else "")
        row = time_segment(key, name, sims[label], what, dev, traced)
        timing.setdefault(name, {}).update(
            {prefix + k: v for k, v in row.items()})
    emit({"phase": "kernel_timing", "gpu": gpu, **timing})
    timing["dcqcn_update"] = time_cc_update(dev, traced)
    emit({"phase": "kernel_timing", "gpu": gpu,
          "dcqcn_update": timing["dcqcn_update"]})

    # ---- 6. DLRM: the embedding-bag kernel against its plain version -------
    emb_check = dlrm_kernel_check(dev)
    emit({"phase": "dlrm_kernel_check", "kernel": "embedding_bag_rows",
          **emb_check})

    # ---- 7. DLRM: Table II scoring through the kernel ----------------------
    emb_launches, timing["embedding_bag_rows"] = dlrm_forward(gpu, dev,
                                                              traced)

    # ---- 7b. the bags' backward kernel against its plain version ---------
    bwd_check = bags_backward_check(dev)
    emit({"phase": "bags_backward_check", "kernel": "embedding_bag_backward",
          **bwd_check})
    timing["embedding_bag_backward"] = time_bags_backward(dev, traced)
    emit({"phase": "kernel_timing", "gpu": gpu,
          "embedding_bag_backward": timing["embedding_bag_backward"]})

    # ---- 7c. training the Table II DLRM through both bag kernels, with
    # the mesh job's ranks starting beside it ----------------------------
    mesh_job, mesh_go = start_mesh_job(tmp)
    try:
        train_launches = train_dlrm(gpu, dev)

        # ---- 7d. the device mesh: four ranks sharing the card, let go now
        # that train_dlrm has freed it; phases 8 and 10 (checks, a few GB)
        # run beside them ------------------------------------------------
        torch.cuda.empty_cache()
        mesh_go.write_text("go")

        # ---- 8. DLRM: against the JAX reference's logits --------------------
        emit({"phase": "dlrm_reference", **dlrm_reference(dev)})

        # ---- 10. serving: the flash-decode kernel against its plain version -
        fd_check = decode_kernel_check(dev)
        emit({"phase": "decode_kernel_check", "kernel": "flash_decode",
              "inputs": "random", **fd_check})

        mesh_launches_dlrm = mesh_phases(gpu, mesh_job)
    finally:
        mesh_job.terminate()

    # ---- 11. serving: the driver's defaults through its entry point --------
    entry_launches = serve_entry(gpu)

    # ---- 12. serving: TinyLlama on a 32,768-token cache ---------------------
    long_launches, fd_layers, timing["flash_decode"] = serve_long(gpu, dev,
                                                                  traced)
    emit({"phase": "decode_kernel_check", "kernel": "flash_decode",
          "inputs": "serve_long decode step", **fd_layers})
    emit({"phase": "kernel_timing", "gpu": gpu,
          "flash_decode": timing["flash_decode"]})

    # ---- 13. serving: against the JAX reference's logits --------------------
    emit({"phase": "serve_reference", **serve_reference(dev)})

    # ---- 13b-d. sliding-window, softcapped serving: Gemma-2 at full depth,
    # Gemma-3 cut to 12 layers, Phi-4-mini, through ServeEngine -------------
    arch_launches = {arch: serve_arch(arch, gpu, dev)[0]
                     for arch in SERVE_ARCHS}

    # ---- 13e. Gemma-2 and Gemma-3 against the JAX reference's logits --------
    for arch in ("gemma2-9b", "gemma3-27b"):
        line, n = serve_sliding_reference(arch, dev)
        emit({"phase": "serve_sliding_reference", **line})
        arch_launches[f"{arch}/reference"] = n

    # ---- 13f. the softcap's instantiation at Gemma-2's decode shape --------
    timing["flash_decode"].update(time_flash_decode_softcap(dev, traced))
    emit({"phase": "kernel_timing", "gpu": gpu, "flash_decode_softcap": {
        k: v for k, v in timing["flash_decode"].items()
        if k.startswith("softcap_")}})

    # ---- 13g. the int8 KV cache: TinyLlama on serve_long's shape ----------
    int8_launches, int8_layers, int8_timing = serve_int8(gpu, dev, traced)
    arch_launches["tinyllama-1.1b/int8"] = int8_launches
    timing["flash_decode"].update({f"int8_{k}": v
                                   for k, v in int8_timing.items()})
    emit({"phase": "kernel_timing", "gpu": gpu,
          "flash_decode_int8": int8_timing})

    # ---- 13h. RWKV-6 and DeepSeek-V2/V3 (MLA + MoE): no kernel ------------
    for arch in SERVE_FAMILIES:
        serve_family(arch, gpu, dev)

    # ---- 13i. the new families against the JAX reference's logits ---------
    for name in FAMILIES_REF_CUTS:
        line, n = serve_families_reference(name, dev)
        emit({"phase": "serve_families_reference", **line})
        arch_launches[f"{name}/reference"] = n

    # ---- 13j-13l. training: TinyLlama with flash attention, the smoke
    # models against the reference (13m, launch.train with a restart, ran
    # beside the child phases) -------------------------------------------
    train_tinyllama(gpu, dev)
    train_reference(gpu, dev)

    # ---- 14. device time of every kernel row and its library call ---------
    # traced last: once the profiler has traced, later launches are slower
    for name in SOURCES:
        entry = traced.pop(name)
        kernel, library, _ = entry() if callable(entry) else entry
        timing[name]["device_us"] = device_us(kernel)
        timing[name]["library_device_us"] = (
            None if library is None else device_us(library))
    # the segment kernels' index_add_ (a PFC row's library_ms is None, but
    # its sums have the same yardstick), and their split-row plans
    for name, prefix, _, _ in SEGMENT_TIMED:
        row = timing[name]
        if prefix:
            kernel, library, _ = traced.pop(f"{name}/{prefix[:-1]}")
            row[prefix + "device_us"] = device_us(kernel)
            row[prefix + "index_add_device_us"] = device_us(library)
        else:
            row["index_add_device_us"] = row["library_device_us"]
        row[prefix + "library_device_us"] = (
            None if row[prefix + "library_ms"] is None
            else row[prefix + "index_add_device_us"])
    fd_t = timing["flash_decode"]
    cap_kernel, nocap_kernel, cap_lib, nocap_lib, _ = traced.pop(
        "flash_decode/softcap")
    fd_t["int8_device_us"] = device_us(traced.pop("flash_decode/int8")[0])
    fd_t["softcap_device_us"] = device_us(cap_kernel)
    fd_t["softcap_nocap_device_us"] = device_us(nocap_kernel)
    fd_t["softcap_library_device_us"] = device_us(cap_lib)
    fd_t["softcap_nocap_library_device_us"] = device_us(nocap_lib)
    fused_t = timing["fused_signals_policy"]
    for prefix, _, _ in FUSED_TIMED[1:]:
        fused_t[prefix + "device_us"] = device_us(
            traced.pop(f"fused_signals_policy/{prefix[:-1]}")[0])
    emit({"phase": "device_time", "gpu": gpu, **{
        name: {key: timing[name][key] for key in (
            "ms", "host_us_per_launch", "device_us", "library_ms",
            "library_device_us", "bound_ms")} for name in SOURCES}, **{
        f"fused_signals_policy/{prefix[:-1]}": {
            key: fused_t[prefix + key] for key in (
                "ms", "ms_hot", "host_us_per_launch", "device_us",
                "bound_ms")} for prefix, _, _ in FUSED_TIMED[1:]}, **{
        f"{name}/{prefix[:-1]}": {
            key: timing[name][prefix + key] for key in (
                "ms", "host_us_per_launch", "device_us", "index_add_ms",
                "index_add_device_us", "bound_ms")}
        for name, prefix, _, _ in SEGMENT_TIMED if prefix}, **{
        "flash_decode/int8": {key: fd_t["int8_" + key] for key in (
            "ms", "ms_hot", "host_us_per_launch", "device_us", "plain_ms",
            "bound_ms")},
        "flash_decode/softcap": {key: fd_t["softcap_" + key] for key in (
            "ms", "ms_hot", "nocap_ms", "nocap_ms_hot", "device_us",
            "nocap_device_us", "bound_ms", "library_ms", "library_ms_hot",
            "library_device_us", "nocap_library_ms", "nocap_library_ms_hot",
            "nocap_library_device_us")}}})

    # ---- kernel table, device line ----------------------------------------
    # launches: the sum over the paths each kernel runs on, each path's
    # counts set to 0 just before it and read just after
    path_launches = {k: main_launches[k] + iter_launches[k]
                     + fig12_launches[k] + mesh_launches[k]
                     + fault_launches[k]
                     + f32_launches[k] + mlp_launches[k]
                     + atlas_launches[k]
                     + child["campaign_ladder32"]["launches"][k]
                     + child["predict32"]["launches"][k]
                     for k in main_launches}
    # the gradient path's backward sums (soft_grad's four runs)
    path_launches["segment_reduce"] += (child["soft_grad"]["segment_launches"]
                                        + child["soft_grad128"][
                                            "segment_launches"])
    path_launches["dcqcn_update"] = ccu_launches
    # the embedding kernels: the scoring forward and train_dlrm's steps
    path_launches["embedding_bag_rows"] = (
        emb_launches["embedding_bag_rows"]
        + train_launches["embedding_bag_rows"]
        + mesh_launches_dlrm["embedding_bag_rows"])
    path_launches["embedding_bag_backward"] = (
        train_launches["embedding_bag_backward"]
        + mesh_launches_dlrm["embedding_bag_backward"])
    path_launches["flash_decode"] = (entry_launches + long_launches
                                     + sum(arch_launches.values()))
    errs = {"fused_signals_policy": fused["max_abs_err"], **seg_err,
            "dcqcn_update": ccu_check["max_abs_err"],
            "embedding_bag_rows": emb_check["max_abs_err"],
            "embedding_bag_backward": bwd_check["max_abs_err"],
            "flash_decode": max(fd_check["max_abs_err"], *(
                r["max_abs_err"] for r in (*fd_layers.values(),
                                           *int8_layers.values())))}
    kernels = []
    for name in SOURCES:
        if path_launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        tm = timing[name]
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": path_launches[name],
               "max_abs_err": errs[name]}
        row.update({key: tm[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_us", "library_device_us", "host_us_per_launch")})
        # flash_decode's ms and library_ms are cold; its hot times beside
        row.update({key: tm[key] for key in ("ms_hot", "library_ms_hot")
                    if key in tm})
        # the fused kernel's mlp body and its B=9 times, timed beside its
        # DCQCN row, and its launches on the mlp paths (counted in
        # launches too)
        row.update({k: v for k, v in tm.items()
                    if k.startswith(("mlp_", "b9_", "qlink_", "qport128_",
                                     "index_add_", "softcap_", "int8_"))})
        if name == "embedding_bag_backward":
            row.update({k: tm[k] for k in (
                "ms_kernel_fill", "sums_ms", "zero_kernel_ms", "zeros_ms",
                "index_ms", "index_add_ms", "shape")})
        if name == "fused_signals_policy":
            row["mlp_launches"] = mlp_launches[name]
        if name == "flash_decode":
            row["launches_by_arch"] = arch_launches
        kernels.append(row)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child-phase"]:
        sys.exit(child_phase_main(sys.argv[2], Path(sys.argv[3])))
    sys.exit(main())
