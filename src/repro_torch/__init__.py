"""PyTorch/CUDA port of the RoCE congestion-control fluid simulator.

A package beside ``repro`` (the JAX reference, which stays as it is); it
imports torch and numpy, never jax and nothing of ``repro``.  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
The engine step's hot loop runs in hand-written CUDA kernels for Hopper
(``repro_torch.kernels.engine_step``); the paper's DLRM
(``repro_torch.models``, ``repro_torch.configs``) scores batches with its
embedding bags in another (``repro_torch.kernels.embedding_bag``), and its
training iteration is simulated as a flow schedule
(``repro_torch.core.workload``).
"""
from repro_torch.core import *  # noqa: F401,F403
