#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the engine-step, DCQCN-update, embedding-bag and
flash-decode kernels, holds each against its plain PyTorch version (the
engine kernels also inside one step of Fig 12's nine lanes and of Fig
13's eight lossy lanes, against the op path), drives the simulator's main
path through the kernels at the paper's 128-GPU scale and at 32 GPUs,
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
JAX reference.  Three gradient phases run through autograd on the op path
(no kernel has a backward), each in a process of its own beside the main
process's simulator phases: ``examples/cc_autotune.py``'s CC and fabric
tunings (``autotune_incast8``), two Adam steps of the ``mlp`` trainer's
curriculum (``learn_step``), and the soft cost's gradient at 32 GPUs
against the reference and at the paper's 128 GPUs with remat
(``soft_grad``).  Before them it measures the backend calibration on the
card (``calibrate``: serial against batched runs, persisted to a temporary
``REPRO_CACHE_DIR``); beside them two more children run resilient
campaigns: the committed 128-GPU atlas
(``experiments/atlas/atlas_paper_ring128.csv``) through ``run_campaign``
until the child SIGKILLs itself before its third chunk, which the main
process then resumes from the journal and holds cell by cell against the
CSV (``campaign_atlas128``), and, after a warm start of the persisted
table, the retry ladder under injected out-of-memory errors on 32 GPUs, on one
device and over a mesh of the card twice (``campaign_ladder32``, its
``no_mesh`` rung), and the HLO-replay prediction of every policy,
batched and serial (``predict32``).  ``soft_grad`` runs the 32-GPU
gradient twice and records whether it repeats bit for bit.

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
FD_SOURCE = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
SOURCES = {"fused_signals_policy": KERNEL_SOURCE,
           "segment_reduce": KERNEL_SOURCE,
           "segment_reduce_pfc": KERNEL_SOURCE,
           "dcqcn_update": CCU_SOURCE,
           "embedding_bag_rows": EMB_SOURCE,
           "flash_decode": FD_SOURCE}
REPLACES = {
    "fused_signals_policy": "src/repro/kernels/engine_step/engine_step.py:96",
    "segment_reduce": "src/repro/kernels/engine_step/engine_step.py:171",
    "segment_reduce_pfc": "src/repro/kernels/engine_step/engine_step.py:195",
    "dcqcn_update": "src/repro/kernels/cc_update/cc_update.py:61",
    "embedding_bag_rows":
        "src/repro/kernels/embedding_bag/embedding_bag.py:31",
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
LEARN_STEPS = 2
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
              "grad_norm": 1.49219732097982},
             {"loss": 2.249004244625685,
              "per_task": {"incast8": 0.000466607918497175,
                           "ring16": 0.00173073704354465,
                           "incast8_lossy_irn": 0.0004685161984525621},
              "grad_norm": 1.3991786661934011}],
 "weights": {"w1_00": 0.02514604421867866,
             "w1_01": -0.026420972658260378,
             "w1_02": 0.22800037592394692,
             "w1_03": 0.12081677031439528,
             "w1_04": -0.007260227113869082,
             "w1_05": 0.1723329128411118,
             "b1_0": 0.10001231191739615,
             "w1_10": 0.26080000902602746,
             "w1_11": 0.18941619262584844,
             "w1_12": -0.10613439348482653,
             "w1_13": -0.21928498064500807,
             "w1_14": -0.09049292223100278,
             "w1_15": 0.04423692508763531,
             "b1_1": 0.035944344585991196,
             "w1_20": -0.46500615492776687,
             "w1_21": -0.043758332786509146,
             "w1_22": -0.34902458627072186,
             "w1_23": -0.24620649324182087,
             "w1_24": -0.208646167788734,
             "w1_25": -0.16322701498983244,
             "b1_2": -0.09996443622055823,
             "w1_30": 0.08232610727482657,
             "w1_31": 0.20850267388853552,
             "w1_32": -0.124841008226725,
             "w1_33": 0.1739824054086092,
             "w1_34": -0.23227221414530846,
             "w1_35": -0.02851495298294693,
             "b1_3": -0.09882287012582182,
             "w2_00": 0.27737934072067805,
             "w2_01": -0.06393975259244115,
             "w2_02": -0.24768194711356592,
             "w2_03": -0.16315545497461909,
             "b2_0": -6.400042164433112,
             "w2_10": -0.0002674441264243488,
             "w2_11": -0.03646668933225707,
             "w2_12": -0.29503770150605424,
             "w2_13": -0.026223019691899038,
             "b2_1": -0.9036360603609014}}
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
}
SERVE_ARCH_SLOTS = 2

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


def _fan_in(name: str, shape: tuple) -> int:
    """The true fan-in of a transformer weight: the product of the dims a
    forward contracts (the reference's init takes ``shape[-2]``, which for
    ``wq``/``wk``/``wv`` (D, H, Dh) is the head count)."""
    if name in ("wq", "wk", "wv"):
        return shape[-3]
    if name == "wo":
        return shape[-3] * shape[-2]
    return shape[-2]


def _init_std(name: str, shape: tuple) -> float:
    """The standard deviation of a transformer weight's draw: ``embed``
    0.02, norm scales and biases 0.1, every matrix 1 / sqrt(true
    fan-in)."""
    if name == "embed":
        return 0.02
    if name in ("scale", "bias"):
        return 0.1
    return 1.0 / np.sqrt(_fan_in(name, shape))


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

    def draw(name, shape):
        std = _init_std(name, shape)
        out = np.empty(shape, np.uint16 if bf16 else np.float32)
        parts = out if len(shape) >= 3 else (out,)
        for part in parts:
            x = rng.standard_normal(part.shape, np.float32) * np.float32(std)
            part[...] = bf16_bits(x) if bf16 else x
        return out

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return draw(name, tuple(node))
    return walk(tree, "")


def hashed_bf16(shape: tuple, seed: int, std: float, device,
                block: int = 1 << 26):
    """A bf16 tensor of ``shape`` on ``device`` whose element i is a
    counter-based integer hash of (i, ``seed``) mapped to a uniform value
    on [-std * sqrt(3), std * sqrt(3)) (the variance of N(0, std^2)) and
    cut to bf16 by truncation.  Integer arithmetic, one exact float32
    step and one float32 multiply: the same bits on the card and on a
    CPU, in milliseconds on the card, where numpy's normal draws of a 9B
    model take minutes of host time."""
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
        out[lo:lo + len(i)] = (w.view(torch.int32) >> 16).to(torch.int16)
    return out.view(torch.bfloat16).reshape(shape)


def hashed_params(tree, seed: int, device):
    """``transformer_numpy_params``' tree and scales (``embed`` 0.02,
    norm scales and biases 0.1, every matrix 1 / sqrt(true fan-in)) drawn
    by ``hashed_bf16`` instead, leaf k (dicts walked in sorted key order,
    lists in order) from seed ``seed * 1_000_003 + k``; the leaves of
    ``tree`` are shapes."""
    count = [0]

    def draw(name, shape):
        count[0] += 1
        return hashed_bf16(shape, seed * 1_000_003 + count[0],
                           _init_std(name, shape), device)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return draw(name, tuple(node))
    return walk(tree, "")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
          "launches": launches,
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


def policy_axis(runner, scen: dict, results: dict, gpu: str) -> None:
    """The 128-GPU 1D all-reduce under pfc, dcqcn and hpcc as one
    policy-axis batch (op path, as the reference runs stacked policies);
    each lane within two steps of ``REFERENCE``, and the dcqcn lane of
    this script's serial kernel-path run.  The dcqcn lane is also the op-path side of
    the 128-GPU kernel-vs-op-path check, at the port's whole-run
    tolerances."""
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
    rows = []
    for i, pol in enumerate(batch.policy_axis):
        ct = float(batch.completion_time[i])
        row = {"policy": pol, "finished": bool(batch.finished[i]),
               "completion_time": ct,
               "reference": REFERENCE[("clos128_1d", pol)],
               "diff_steps_reference": float(steps_apart(
                   ct, REFERENCE[("clos128_1d", pol)], DT)),
               "pause_frames": float(batch.pause_count[i].sum())}
        ser = results.get(("clos128_1d", pol))   # phase 3 runs dcqcn only
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
          "rows": rows, "tolerance_steps": 2})
    i = batch.policy_axis.index("dcqcn")
    lane = SimpleNamespace(
        finished=bool(batch.finished[i]),
        completion_time=float(batch.completion_time[i]),
        t_finish=batch.t_finish[i], delivered=batch.delivered[i],
        pause_count=batch.pause_count[i])
    emit({"phase": "kernel_vs_op_path", "scenario": "clos128_1d",
          "policy": "dcqcn", "op_path": "policy_axis lane",
          **compare_runs(results[("clos128_1d", "dcqcn")], lane, DT,
                         "clos128_1d dcqcn")})


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
          "op_path_wall_s": op_wall,
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
    emit({"phase": "mlp_clos128", "gpu": gpu, "policy": "mlp", **rows})
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


def no_kernel_launches(before: dict, what: str) -> None:
    from repro_torch.kernels.engine_step import ops
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]}
    if launched:
        raise AssertionError(f"{what}: the gradient path launched kernels "
                             f"{launched}")


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
        no_kernel_launches(before, f"autotune {run}")
        rows[run] = {"population": kw["population"],
                     "s_per_descent_step": wall / kw["steps"],
                     **compare_tune(res, AUTOTUNE_REFERENCE[run],
                                    f"autotune {run}")}
    emit({"phase": "autotune_incast8", "gpu": gpu, "device": "cuda",
          "kernel_launches": 0, **rows})


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
    no_kernel_launches(before, "learn_step")
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
          "kernel_launches": 0, **row,
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


def soft_grad(runner, scen: dict, forward, gpu: str) -> None:
    """The soft cost and its gradient through autograd on the op path:
    at 32 GPUs against the reference's value (bit for bit) and gradient,
    run twice to record whether the card's gradient repeats bit for bit
    (recorded, not held: ``ROADMAP.md`` §3);
    at the paper's 128 GPUs (``remat``, ``SOFT_GRAD_CHUNK`` steps a
    segment) with a finite gradient; each value bit-equal to the forward
    runs' ``Results.soft_cost`` of phases 3-4, which ``forward()``
    returns (scenario -> soft cost and executed steps);
    ``step_impl="cuda"`` refuses it."""
    import dataclasses
    from repro_torch.core import ScenarioSpec
    from repro_torch.kernels.engine_step import ops
    rows = {}
    for label, remat, chunk in (("clos32_2d", False, None),
                                ("clos128_1d", True, SOFT_GRAD_CHUNK)):
        fab, wl = scen[label]
        cfg = runner.cfg if chunk is None else dataclasses.replace(
            runner.cfg, chunk_steps=chunk)
        sim = runner.simulator(*ScenarioSpec(fab, wl, "dcqcn").build(), cfg)
        before = dict(ops.LAUNCHES)
        v, grads, fwd_s, bwd_s, peak = soft_grad_run(sim, remat)
        no_kernel_launches(before, f"soft_grad {label}")
        rows[label] = {"remat": remat, "chunk_steps": chunk,
                       "soft_cost": v, "grad": grads,
                       "seconds": fwd_s + bwd_s, "fwd_s": fwd_s,
                       "bwd_s": bwd_s, "peak_bytes": peak}
        if label == "clos32_2d":
            # does the card's gradient repeat?  The same run again in this
            # process: the backward's index_add_ adds with atomics on CUDA
            v2, grads2 = soft_grad_run(sim, remat)[:2]
            no_kernel_launches(before, f"soft_grad {label} again")
            diff = {k: abs(grads2[k] - grads[k]) for k in grads}
            repeat = {"soft_cost_equal": v2 == v,
                      "grad_bit_equal": all(grads2[k] == grads[k]
                                            for k in grads),
                      "grad_again": grads2, "grad_max_abs_diff":
                      max(diff.values()), "grad_max_rel_diff": max(
                          rel_err(grads2[k], grads[k]) for k in grads)}
    fwd = forward()
    for label, row in rows.items():
        steps = fwd[label]["steps_executed"]
        row.update(steps=steps,
                   fwd_host_ms_per_step=1e3 * row.pop("fwd_s") / steps,
                   bwd_host_ms_per_step=1e3 * row.pop("bwd_s") / steps,
                   forward_run_soft_cost=fwd[label]["soft_cost"])
        if row["soft_cost"] != row["forward_run_soft_cost"] or not all(
                np.isfinite(x) for x in row["grad"].values()):
            raise AssertionError(f"soft_grad {label}: {row}")
        v, grads = row["soft_cost"], row["grad"]
        want = SOFT_GRAD_REFERENCE.get(label)
        if want is not None:
            row["grad_max_rel_err"] = max(rel_err(grads[k], w)
                                          for k, w in want["grad"].items())
            row["reference_soft_cost"] = want["soft_cost"]
            if v != want["soft_cost"] or row["grad_max_rel_err"] > 1e-3:
                raise AssertionError(f"soft_grad {label} vs the reference: "
                                     f"{row}")
    kern = runner.simulator(*ScenarioSpec(*scen["clos32_2d"], "dcqcn").build(),
                            dataclasses.replace(runner.cfg,
                                                step_impl="cuda"))
    try:
        kern.soft_cost_fn()
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("soft_cost_fn ran with step_impl='cuda'")
    emit({"phase": "soft_grad", "gpu": gpu, "keys": list(SOFT_GRAD_KEYS),
          "kernel_launches": 0, **rows, "clos32_2d_repeat": repeat,
          "cuda_step_impl_refused": refused,
          "tolerance": "soft cost bit-equal; gradient finite, rtol 1e-3 "
                       "of the reference where it is known"})


# the phases run in processes of their own, beside phases 3-5i: the three
# gradient phases, the atlas campaign until its SIGKILL, and the ladder
# and prediction phases (after the warm start of phase 2b's table)
CHILD_PHASES = ("learn_step", "soft_grad", "autotune_incast8",
                "campaign_atlas128_kill", "campaigns")
# what a child phase's wall seconds were taken beside
CONTENDED = ("wall seconds under contention: in a child process beside the "
             "other child phases and the main process's phases 3-5i")


def start_child_phases(tmp: Path) -> dict:
    """Each child phase in a process of its own (``--child-phase NAME
    TMP``), beside the main process's phases 3-5i: all of them are bound
    by one host core each, not by the card.  Output goes to files in
    ``tmp``; the children inherit phase 2b's ``REPRO_CACHE_DIR``."""
    procs = {}
    for name in CHILD_PHASES:
        out = open(tmp / f"{name}.out", "w")
        err = open(tmp / f"{name}.err", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child-phase",
             name, str(tmp)], stdin=subprocess.PIPE, stdout=out, stderr=err,
            text=True), out, err)
    return procs


def finish_child_phases(procs: dict, tmp: Path, forward: dict) -> dict:
    """Hand ``soft_grad`` the forward runs' soft costs, wait for every
    child phase, print its lines, and fail if one failed (the atlas child
    must have died by its own SIGKILL).  Returns each child's JSON lines
    by phase."""
    stdin = procs["soft_grad"][0].stdin
    stdin.write(json.dumps(forward) + "\n")
    stdin.close()
    failed, lines = [], {}
    for name, (proc, out, err) in procs.items():
        proc.wait()
        out.close()
        err.close()
        text = (tmp / f"{name}.out").read_text()
        sys.stdout.write(text)
        sys.stdout.flush()
        for ln in text.splitlines():
            if ln.startswith("{"):
                obj = json.loads(ln)
                lines[obj.get("phase")] = obj
        want = -signal.SIGKILL if name == "campaign_atlas128_kill" else 0
        if proc.returncode != want:
            failed.append(f"{name} (exit {proc.returncode}, expected "
                          f"{want}): "
                          + (tmp / f"{name}.err").read_text()[-3000:])
    if failed:
        raise AssertionError("child phases failed: " + "; ".join(failed))
    return lines


def stop_processes(procs: dict) -> None:
    for proc, out, err in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def child_phase_main(name: str, tmp: Path) -> int:
    """One child phase in this process (``main`` starts it)."""
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import EngineConfig, SweepRunner
    gpu = gpu_line()
    if name == "autotune_incast8":
        autotune_incast8(gpu)
    elif name == "learn_step":
        learn_step(gpu)
    elif name == "campaign_atlas128_kill":
        campaign_atlas128_kill(tmp / "atlas")
    elif name == "campaigns":
        calibrate_warm_start()
        campaign_ladder32(gpu, tmp / "ladder")
        predict32(gpu)
    else:
        runner = SweepRunner(EngineConfig(dt=DT, max_steps=6000,
                                          max_extends=6, queue_stride=0),
                             device="cuda")

        def forward():
            return json.loads(sys.stdin.readline())
        soft_grad(runner, main_scenarios(), forward, gpu)
    return 0


# ---------------------------------------------------------------------------
# phases 2b, 5m-5p: backend calibration, campaigns, HLO-replay prediction
# ---------------------------------------------------------------------------

def calibrate(gpu: str) -> dict:
    """``calibrate_backend(device="cuda")`` with the default probes (90
    and 1,806 flows, B=6), persisted to this run's ``REPRO_CACHE_DIR``:
    the table and every probe's serial and batched seconds."""
    from repro_torch.core.sweep import (calibrate_backend,
                                        calibration_cache_path)
    t0 = time.perf_counter()
    cal = calibrate_backend(device="cuda")
    path = calibration_cache_path("cuda")
    if not Path(path).is_file():
        raise AssertionError(f"calibrate: no table persisted at {path}")
    rec = cal.record()
    emit({"phase": "calibrate", "gpu": gpu,
          "seconds": time.perf_counter() - t0, **rec,
          "batching_loses": [p for p in rec["probes"]
                             if p["batched_s"] >= p["serial_s"]]})
    return rec


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
                    "resumed in the main process with nothing beside it",
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
    launch, lib_fn, (_, idx, _, _), (T, R, D, P) = embedding_calls(
        model, B, dev)
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


def fd_tolerance(q, k, v, length, want, softcap=None):
    """Flash decode's tolerance, per output element: 1e-5 of the
    softmax-weighted sum of |v| (the scale of the terms the output sums),
    plus one bf16 ulp of the plain version's output ``want`` for bf16.
    With a softcap the scores pass through ``cap * tanh(s / cap)``, whose
    float32 tanh on each side is within 2 ulps of a value below 1: up to
    ``cap * 2**-22`` more on each score, so as much more of that sum."""
    import torch
    from repro_torch.kernels.flash_decode import ref
    rel = 1e-5 + (0.0 if softcap is None else softcap * 2.0 ** -22)
    tol = rel * ref.flash_decode_ref(q.float(), k.float(), v.float().abs(),
                                     length, softcap)
    if want.dtype == torch.bfloat16:
        w = want.float().abs()
        tol = tol + torch.where(w > 0, torch.exp2(torch.floor(torch.log2(w))
                                                  - 7), 0)
    return tol


def fd_compare(q, k, v, length, softcap=None) -> dict:
    """The flash-decode kernel against its plain version on one input, and
    the kernel with the default split (``max_length`` S) against the
    kernel split to the lengths: equal.  Tolerance: float32 within 1e-5 of
    the softmax-weighted sum of |v|; bf16 within 1 bf16 ulp plus that
    (equal or 1 ulp apart unless the output cancels: counted)."""
    import torch
    from repro_torch.kernels.flash_decode import ops, ref
    got = ops.flash_decode(q, k, v, length, max_length=int(length.max()),
                           softcap=softcap)
    again = ops.flash_decode(q, k, v, length, softcap=softcap)
    want = ref.flash_decode_ref(q, k, v, length, softcap)
    err = (got.float() - want.float()).abs()
    tol = fd_tolerance(q, k, v, length, want, softcap)
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
    two rows, with the softcap and without."""
    import torch
    from repro_torch.kernels.flash_decode import ops
    gen = torch.Generator(device=dev).manual_seed(13)
    C = ops.CHUNK
    totals = {"cases": 0, "elements": 0, "equal": 0, "one_ulp": 0,
              "beyond_one_ulp": 0, "max_abs_err": 0.0, "scalar_loads": 0,
              "softcap_cases": 0, "arch_cases": 0}
    t0 = time.perf_counter()

    def check(q, k, v, what, softcap=None):
        B, S = k.shape[:2]
        lens = sorted({n for n in (1, C - 1, C, C + 1, S - 17, S)
                       if 1 <= n <= S})
        vecs = [[n] * B for n in lens]
        if B > 1:
            vecs.append([lens[b % len(lens)] for b in range(B)])
        for vec in vecs:
            length = torch.tensor(vec, dtype=torch.int32, device=dev)
            r = fd_compare(q, k, v, length, softcap)
            if not r["ok"]:
                raise AssertionError(f"flash_decode {what} lengths {vec}: {r}")
            totals["cases"] += 1
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
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    totals["seconds"] = time.perf_counter() - t0
    totals["tolerance"] = ("float32: 1e-5 x softmax-weighted sum of |v|, "
                           "+ cap x 2^-22 of it with a softcap; bf16: that "
                           "+ 1 bf16 ulp; split-independent")
    return totals


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
    the layers ``want`` (0-based, counted per call in layer order), then
    calls it as before."""

    def __init__(self, n_layers: int, want: tuple):
        self.n_layers, self.want, self.calls, self.inputs = \
            n_layers, want, 0, {}
        self.softcap = {}

    def __enter__(self):
        from repro_torch.kernels.flash_decode import ops
        self.ops, self.orig = ops, ops.gqa_decode_attention

        def wrapped(q, k, v, length, max_length=None, softcap=None):
            layer = self.calls % self.n_layers
            self.calls += 1
            if layer in self.want:
                B, _, Hq, D = q.shape
                Hkv = k.shape[2]
                self.inputs[layer] = (q.reshape(B, Hkv, Hq // Hkv, D).clone(),
                                      k.clone(), v.clone(), length.clone())
                self.softcap[layer] = softcap
            return self.orig(q, k, v, length, max_length, softcap)
        ops.gqa_decode_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.gqa_decode_attention = self.orig


class plain_decode_attention:
    """While active, the model's ``decode_impl="cuda"`` decode attention
    runs the kernel's plain version (``ref.flash_decode_ref``: float32
    scores, softcap, softmax and p.v) on the card in the kernel's place,
    over the same positions: the yardstick of the kernel inside a model.
    No kernel launches."""

    def __enter__(self):
        from repro_torch.kernels.flash_decode import ops, ref
        self.ops, self.orig = ops, ops.gqa_decode_attention

        def plain(q, k, v, length, max_length=None, softcap=None):
            B, _, Hq, D = q.shape
            Hkv = k.shape[2]
            n = k.shape[1] if max_length is None else max_length
            out = ref.flash_decode_ref(q.reshape(B, Hkv, Hq // Hkv, D),
                                       k[:, :n], v[:, :n], length, softcap)
            return out.reshape(B, 1, Hq, D)
        ops.gqa_decode_attention = plain
        return self

    def __exit__(self, *exc):
        self.ops.gqa_decode_attention = self.orig


def time_flash_decode(inputs, traced: dict) -> dict:
    """The kernel (direct C calls), its plain version and
    ``F.scaled_dot_product_attention(..., enable_gqa=True)`` on the cache
    sliced to the (common) length, on captured decode inputs ``[(q, k, v,
    length), ...]``.  Cold (``ms``, ``library_ms``): each call takes the
    next of ``FD_COLD_SETS`` input sets, the captured layers and copies of
    them, whose live K/V together exceed ``FD_COLD_BYTES``, as the decode
    step meets a layer's cache after 21 other layers' and the weights; hot
    (``ms_hot``, ``library_ms_hot``): one set over and over, L2-resident."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops, ref
    sets = list(inputs)
    while len(sets) < FD_COLD_SETS:
        sets.append(tuple(x.clone() for x in inputs[len(sets) % len(inputs)]))
    q, k, v, length = sets[0]
    B, Hkv, G, D = q.shape
    lens = length.tolist()
    L = max(lens)
    item = q.element_size()
    n_bytes = sum(lens) * Hkv * D * item * 2 + 2 * q.numel() * item + 4 * B
    if n_bytes * len(sets) <= FD_COLD_BYTES:
        raise AssertionError(f"time_flash_decode: {len(sets)} sets of "
                             f"{n_bytes} live bytes stay in L2")
    splits = ops.n_splits(k.shape[1], L)
    fn = ops.kernel_function()
    stream = torch.cuda.current_stream().cuda_stream
    args, sdpa_in, outs = [], [], []
    for (qi, ki, vi, li) in sets:
        part_acc, part_ml = ops.scratch(qi, splits)
        out = torch.empty_like(qi)
        outs.append((out, part_acc, part_ml))
        args.append(ops.kernel_args(qi, ki, vi, li, out, splits, part_acc,
                                    part_ml))
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
    library, library_hot = cuda_ms(sdpa), cuda_ms(lambda: sdpa(0))
    traced["flash_decode"] = (launch, sdpa, (sets, outs))
    plain = cuda_ms(lambda: ref.flash_decode_ref(q, k, v, length), reps=10,
                    inner=5)
    launch(0)
    diff = (sdpa(0).reshape(B, Hkv, G, D).float() - outs[0][0].float())
    flops = 4 * sum(lens) * Hkv * G * D
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"ms": ms, "ms_hot": ms_hot,
            "host_us_per_launch": host_us(launch), "plain_ms": plain,
            "library_ms": library, "library_ms_hot": library_hot,
            "library_host_us_per_call": host_us(sdpa),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": f"B={B} Hkv={Hkv} G={G} D={D} S={k.shape[1]} "
                     f"length={L} splits={splits}", "bytes": n_bytes,
            "cold_sets": len(sets), "cold_live_bytes": n_bytes * len(sets),
            "library_max_abs_diff": float(diff.abs().max())}


def serve_long(gpu: str, dev, traced: dict) -> tuple:
    """TinyLlama-1.1B at full width and depth with numpy weights at the
    true fan-in: 8 requests of 2,048-token prompts (the blockwise prefill)
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
    params, draw_s = draw_serving_weights(model, SERVE_SEED, dev)
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


def serve_arch(arch: str, gpu: str, dev) -> int:
    """``SERVE_ARCHS[arch]`` through ``ServeEngine`` on the card: full width
    (depth as listed), hashed weights at the true fan-in, 2 slots, one
    prompt per slot, decode attention in the kernel (one launch per layer
    and decode step, ring layers included); then, teacher-forced on the
    engine's tokens, the kernel path against the same model with the
    kernel's plain version in its place (``plain_decode_attention``) and
    against the torch path (the reference's serving math, which rounds p
    to bf16 before p.v), each per step at ``SERVE_REL_L2`` scaled by
    sqrt(depth / ``SERVE_REL_L2_DEPTH``) above TinyLlama's depth; and the
    kernel against its plain version on the captured inputs of a local
    and a global layer of the last step, at ``fd_compare``'s tolerance.
    Returns the engine's kernel launches."""
    import torch
    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    spec = SERVE_ARCHS[arch]
    cfg = arch_config(arch, spec["layers"], spec["block"])
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params, draw_s = card_weights(model, SERVE_SEED, dev)
    rng = np.random.default_rng(SERVE_SEED)
    S, new = spec["prompt"], spec["new"]
    prompts = rng.integers(0, cfg.vocab, (SERVE_ARCH_SLOTS, S),
                           dtype=np.int32)
    eng = ServeEngine(model, params, batch_slots=SERVE_ARCH_SLOTS,
                      max_len=spec["max_len"], decode_impl="cuda")
    reqs = [Request(i, prompts[i], new) for i in range(SERVE_ARCH_SLOTS)]
    ops.reset_launches()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_decode"]
    (tm,) = eng.timings
    if tm["decode_steps"] != new - 1 or \
            launches != cfg.n_layers * tm["decode_steps"]:
        raise AssertionError(f"{spec['phase']}: {launches} launches for "
                             f"{tm['decode_steps']} decode steps of "
                             f"{cfg.n_layers} layers")
    toks = np.stack([r.tokens for r in results])
    if toks.shape != (SERVE_ARCH_SLOTS, new) or toks.min() < 0 or \
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
    bound = SERVE_REL_L2 * max(1.0, math.sqrt(cfg.n_layers
                                              / SERVE_REL_L2_DEPTH))
    kinds = [k[0] for g in model.groups for _ in range(g.n) for k in g.kinds]
    want_layers = tuple(sorted({kinds.index(k) for k in set(kinds)}))
    cap = capture_decode_inputs(cfg.n_layers, want_layers)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())
    for t in range(new - 1):
        cur = toks[:, t:t + 1]
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
    for layer, (q, k, v, length) in cap.inputs.items():
        r = fd_compare(q, k, v, length, cap.softcap[layer])
        layer_checks[f"layer{layer}_{kinds[layer]}"] = {
            "cache_slots": k.shape[1], "length": int(length.max()),
            "softcap": cap.softcap[layer], **r}
        if not r["ok"]:
            raise AssertionError(f"{spec['phase']}: flash_decode on layer "
                                 f"{layer}'s decode inputs: {r}")
    line = {"phase": spec["phase"], "gpu": gpu, "arch": cfg.name,
            "n_layers": cfg.n_layers,
            "full_depth": get_config(arch).n_layers == cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "local_layers": kinds.count("gqa_l"),
            "global_layers": kinds.count("gqa_g"), "window": cfg.window,
            "logit_softcap": cfg.logit_softcap,
            "block_q": cfg.block_q, "slots": SERVE_ARCH_SLOTS, "prompt": S,
            "new_tokens": new, "max_len": spec["max_len"],
            "weight_bytes": tree_bytes(params), "weights_draw_s": draw_s,
            "prefill_ms": tm["prefill_s"] * 1e3,
            "decode_ms_per_step": tm["decode_s"] / tm["decode_steps"] * 1e3,
            "torch_path_decode_ms_per_step": torch_s / (new - 1) * 1e3,
            "tokens_per_s": SERVE_ARCH_SLOTS * new
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
            "greedy_agreement": agree / (SERVE_ARCH_SLOTS * (new - 1)),
            "tokens_0": toks[0, :16].tolist(),
            "layer_checks": layer_checks,
            "tolerance": f"kernel path vs its plain version in its place "
                         f"and vs the torch path: rel L2 <= {bound:.4g} per "
                         f"step ({SERVE_REL_L2} x sqrt({cfg.n_layers} / "
                         f"{SERVE_REL_L2_DEPTH}) above {SERVE_REL_L2_DEPTH} "
                         "layers); each captured layer at fd_compare's"}
    emit(line)
    if max(rel) > bound or max(rel_kt) > bound:
        raise AssertionError(f"{spec['phase']}: kernel path off its plain "
                             f"version or the torch path: {line}")
    del model, params, eng, cache_c, cache_p, cache_t
    torch.cuda.empty_cache()
    return launches


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


def compare_reference_logits(got, ref: dict) -> dict:
    """Logits ``got`` (steps, rows, V) against a reference record
    (``logits`` at ``SERVE_REF_IDS``, ``lse``, ``top1``, ``margin``) at
    ``serve_reference``'s tolerances, the absolute ones (logits at the
    ids, log-sum-exp, near-tie margin) scaled by the record's logit scale
    over ``SERVE_REF``'s (bf16 rounding errors scale with the logits: a
    tied embedding of std 0.02 read out over sqrt(d_model), as the Gemma
    configs do, gives logits about 50x smaller than TinyLlama's head);
    ``ok`` says whether they hold."""
    import torch
    scale = logit_scale(ref) / logit_scale(SERVE_REF)
    atol, lse_atol = SERVE_REF_ATOL * scale, SERVE_REF_LSE_ATOL * scale
    ids = torch.as_tensor(SERVE_REF_IDS)
    at_ids = got[:, :, ids].numpy()
    want = np.asarray(ref["logits"], np.float32)
    lse = torch.logsumexp(got, -1).numpy()
    top1 = got.argmax(-1).numpy()
    differ = top1 != np.asarray(ref["top1"])
    margin = np.asarray(ref["margin"])
    out = {"max_abs_err_at_ids": float(np.abs(at_ids - want).max()),
           "rel_l2_at_ids_max": float(max(
               np.linalg.norm(at_ids[s] - want[s]) / np.linalg.norm(want[s])
               for s in range(len(want)))),
           "lse_max_abs_err": float(np.abs(lse - np.asarray(
               ref["lse"])).max()),
           "top1_equal": int((~differ).sum()), "top1_total": differ.size,
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

    from repro_torch.core import EngineConfig, ScenarioSpec, SweepRunner
    from repro_torch.kernels import build
    from repro_torch.kernels.engine_step import ops

    # ---- 1. build (one nvcc per source, all at once) ----------------------
    gpu = gpu_line()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    info = build.BUILD_INFO
    # every fused_signals_policy_kernel<N>: registers, spills, SASS
    # instructions and asynchronous copies; each must copy asynchronously
    ptxas = {k: ptxas_summary(v.get("ptxas", "")) for k, v in info.items()}
    fused_sass = {k: dict(v, ptxas=ptxas.get("engine_step", {}).get(k))
                  for k, v in sass_counts(build.build("engine_step")).items()
                  if k.startswith("fused_signals_policy_kernel")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: v.get("seconds") for k, v in info.items()},
          "nvcc": next(iter(info.values()), {}).get("nvcc"), "gpu": gpu,
          "ptxas": ptxas, "fused_sass": fused_sass,
          "flash_decode_sass": sass_counts(build.build("flash_decode"))})
    for k, v in fused_sass.items():
        if not v["LDGSTS"] + v["UBLKCP"] + v["UTMALDG"]:
            raise AssertionError(f"{k}: no asynchronous copy in its SASS")

    cfg = EngineConfig(dt=DT, max_steps=6000, max_extends=6, queue_stride=0)
    runner = SweepRunner(cfg, device="cuda")
    scen = main_scenarios()
    sims = {}
    for label, (fab, wl) in scen.items():
        topo, sched, pol = ScenarioSpec(fab, wl, "dcqcn").build()
        sims[label] = runner.simulator(topo, sched, pol)
    sims["fig12"] = runner.simulator(*fig12_scenario())

    # ---- 2. kernels against their plain versions -------------------------
    # at every padded flow count and plan of the main paths, B in CHECK_LANES
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
    s128 = sims["clos128_1d"]
    traced = {}          # kernel row -> its timed calls, for phase 14
    timing = {"fused_signals_policy": time_fused(s128, sims["fig12"], dev,
                                                 traced)}
    for name, prefix, label, what in SEGMENT_TIMED:
        key = name + (f"/{prefix[:-1]}" if prefix else "")
        row = time_segment(key, name, sims[label], what, dev, traced)
        timing.setdefault(name, {}).update(
            {prefix + k: v for k, v in row.items()})
    emit({"phase": "kernel_timing", "gpu": gpu, **timing})
    ccu_check = check_cc_update(dev)
    emit({"phase": "cc_update_check", "kernel": "dcqcn_update", **ccu_check})
    timing["dcqcn_update"] = time_cc_update(dev, traced)
    emit({"phase": "kernel_timing", "gpu": gpu,
          "dcqcn_update": timing["dcqcn_update"]})

    # ---- 2b. the backend calibration, persisted for the child phases -----
    # (before any child starts: its probes are wall-clock times)
    import tempfile
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    os.environ["REPRO_CACHE_DIR"] = str(tmp / "cache")
    try:
        calibration = calibrate(gpu)
        # ---- 5j-5p start: gradients through the simulator, the atlas
        # campaign until its SIGKILL, the ladder and the prediction, one
        # process each (no kernel is timed until they are done: phases
        # 6-14 follow them)
        procs = start_child_phases(tmp)
        try:
            return main_paths(dev, gpu, t_start, runner, cfg, scen, sims,
                              timing, traced, fused, seg_err, ccu_check,
                              procs, tmp, calibration)
        finally:
            stop_processes(procs)
    finally:
        tmp_dir.cleanup()


def main_paths(dev, gpu, t_start, runner, cfg, scen, sims, timing, traced,
               fused, seg_err, ccu_check, procs, tmp, calibration) -> int:
    """Phases 3-14 and the result lines (``main``'s second half)."""
    import torch
    from repro_torch.core import ScenarioSpec
    from repro_torch.kernels.engine_step import ops
    s128, s32 = sims["clos128_1d"], sims["clos32_2d"]

    # ---- 3. main path at the paper's scale ---------------------------------
    # (pfc and hpcc run at this scale in phase 5d's policy-axis batch and
    # mlp in phase 5h, each against the reference)
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
    # lane of phase 5d's policy-axis batch

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

    # ---- 5. against the JAX reference ---------------------------------------
    rows = []
    for key, want in REFERENCE.items():
        if key not in results:           # held in phase 5d instead
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

    # ---- 5c. Fig 12's fabric sweep as one batch of 9 lanes ------------------
    fig12_launches, fig12_batch = batch_fig12(runner, gpu)

    # ---- 5c'. the same 9 lanes over a mesh of the card, twice ---------------
    mesh_launches = mesh_lanes(runner, sims["fig12"], fig12_batch, gpu)
    del fig12_batch

    # ---- 5d. the policy comparison as one policy-axis batch (op path) ------
    policy_axis(runner, scen, results, gpu)

    # ---- 5e. the faulty step under mlp, kernel vs op path, paper scale -----
    emit({"phase": "lossy_step_check", **lossy_step_check(runner)})

    # ---- 5f. Fig 13's fault lanes as one batch (kernel path) ---------------
    fault_launches = fault_grid_dcqcn(runner, gpu)

    # ---- 5g. every engine kernel under loss, ECN scale and degradation -----
    f32_launches = faults_clos32(runner, scen, gpu)

    # ---- 5h. the learned policy on the kernel path, lossless and lossy -----
    mlp_launches = mlp_clos128(runner, scen, gpu)

    # ---- 5i. the held-out incast, all eight policies (op path) ------------
    mlp_heldout16(gpu)

    # ---- 5j-5p end: the child phases' lines ------------------------------
    child = finish_child_phases(procs, tmp, {
        label: {"soft_cost": results[label, "dcqcn"].soft_cost,
                "steps_executed": results[label, "dcqcn"].meta[
                    "steps_executed"]}
        for label in ("clos128_1d", "clos32_2d")})
    if child["calibrate_warm_start"]["record"] != calibration:
        raise AssertionError("calibrate_warm_start: the child's table "
                             f"{child['calibrate_warm_start']} differs from "
                             f"phase 2b's {calibration}")

    # ---- 5m. the atlas campaign, resumed from the killed child's journal --
    atlas_launches = campaign_atlas128(gpu, tmp / "atlas",
                                       child["campaign_atlas128_kill"])

    # ---- 6. DLRM: the embedding-bag kernel against its plain version -------
    emb_check = dlrm_kernel_check(dev)
    emit({"phase": "dlrm_kernel_check", "kernel": "embedding_bag_rows",
          **emb_check})

    # ---- 7. DLRM: Table II scoring through the kernel ----------------------
    emb_launches, timing["embedding_bag_rows"] = dlrm_forward(gpu, dev,
                                                              traced)

    # ---- 8. DLRM: against the JAX reference's logits ------------------------
    emit({"phase": "dlrm_reference", **dlrm_reference(dev)})

    # ---- 9. DLRM: the training iteration under each policy ------------------
    iter_launches = dlrm_iteration(cfg, gpu)

    # ---- 10. serving: the flash-decode kernel against its plain version -----
    fd_check = decode_kernel_check(dev)
    emit({"phase": "decode_kernel_check", "kernel": "flash_decode",
          "inputs": "random", **fd_check})

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
    arch_launches = {arch: serve_arch(arch, gpu, dev)
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
    path_launches["dcqcn_update"] = ccu_launches
    path_launches.update(emb_launches)
    path_launches["flash_decode"] = (entry_launches + long_launches
                                     + sum(arch_launches.values()))
    errs = {"fused_signals_policy": fused["max_abs_err"], **seg_err,
            "dcqcn_update": ccu_check["max_abs_err"],
            "embedding_bag_rows": emb_check["max_abs_err"],
            "flash_decode": max(fd_check["max_abs_err"], *(
                r["max_abs_err"] for r in fd_layers.values()))}
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
                                     "index_add_", "softcap_"))})
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
