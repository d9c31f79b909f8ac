"""scx_torch — the PyTorch/CUDA port of scx, for one NVIDIA H100.

`scx/` (JAX) is the reference; this package computes the same things with
plain PyTorch around hand-written Hopper kernels, and imports neither
`jax` nor `scx`. Tests hold each module against its `scx` counterpart.

scx computes every matmul at `Precision.HIGHEST`, so TF32 is switched off
here for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
