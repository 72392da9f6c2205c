"""PyTorch/CUDA port of gymnasium_robotics_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference: every stage here is held
against the JAX function it replaces (tests/test_torch_*.py). This package
imports neither ``jax`` nor ``gymnasium_robotics_tpu``; it reads the JAX
package's shipped model files by path only.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

import torch

# float32 matmuls stay in full float32 (no TF32), mirroring the pinned
# "highest" matmul precision of the JAX package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
