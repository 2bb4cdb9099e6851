"""Learned congestion control (port of ``repro.learn``): the per-flow MLP
policy ``mlp`` with its committed trained weights (``net``), and its
trainer (``train``): Adam on the simulator's differentiable soft cost
over a curriculum of scenarios, through autograd on the op path."""
from repro_torch.learn.net import (HIDDEN, N_FEATURES,  # noqa: F401
                                   WEIGHT_KEYS, default_weights,
                                   init_weights, make_mlp)
from repro_torch.learn.train import (LearnResult, TrainConfig,  # noqa: F401
                                     curriculum_default, heldout_default,
                                     heldout_eval, load_checkpoint,
                                     save_checkpoint, train, train_smoke)
