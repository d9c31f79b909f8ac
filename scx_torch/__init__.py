"""scx_torch — the PyTorch/CUDA port of scx, for one NVIDIA H100.

`scx/` (JAX) is the reference; this package computes the same things with
plain PyTorch around hand-written Hopper kernels, and imports neither
`jax` nor `scx`. Tests hold each module against its `scx` counterpart.

scx computes every matmul at `Precision.HIGHEST`, so TF32 is switched off
here for the whole process.

Entry points that make tensors run on the card unless the caller names
another device (`device="cpu"`): see `resolve_device`.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, and raises when
    there is none (never a silent fall back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: scx_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
