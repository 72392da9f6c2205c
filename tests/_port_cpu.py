"""Imported by every `tests/test_torch_*.py` file: one intra-op thread for
torch in each pytest process.

The suite runs under `pytest -n 6` on an 8-core machine. Left at its
default, torch sizes its pool to every core in each of the six workers,
and the idle pool threads spin beside the JAX compiles of the other
workers. The port's CPU tests use small batches, where one thread loses
nothing."""

import torch

torch.set_num_threads(1)
