"""Learned congestion control (port of ``repro.learn``): the per-flow MLP
policy ``mlp`` with its committed trained weights.  Training through the
simulator waits for autograd on the op path."""
from repro_torch.learn.net import (HIDDEN, N_FEATURES,  # noqa: F401
                                   WEIGHT_KEYS, default_weights,
                                   init_weights, make_mlp)
