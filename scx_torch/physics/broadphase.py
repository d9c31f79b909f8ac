"""Fixed-capacity compaction of a pair mask (port of
scx.physics.broadphase.compact_flat_indices).

scx recovers ranks block by block because scatters are slow on a TPU;
here a prefix sum gives each valid entry its rank and one index write puts
it in its slot. The output is identical.
"""

from __future__ import annotations

import torch


def compact_flat_indices(valid: torch.Tensor, max_pairs: int):
    """valid [..., M] bool -> (kflat [..., max_pairs] i32, n_valid [...] i32).

    kflat holds the flat indices of the first max_pairs True entries in
    ascending order, 0-filled past the count; n_valid is the total number
    of True entries (which may exceed max_pairs)."""
    m = valid.shape[-1]
    rank = torch.cumsum(valid, dim=-1, dtype=torch.int32)
    slot = torch.where(valid, rank - 1, max_pairs).clamp(max=max_pairs).long()
    flat = torch.arange(m, dtype=torch.int32, device=valid.device)
    out = torch.zeros(
        valid.shape[:-1] + (max_pairs + 1,), dtype=torch.int32,
        device=valid.device,
    )
    # every entry past the capacity lands in the spare last slot, dropped
    out.scatter_(-1, slot, flat.expand_as(slot))
    return out[..., :max_pairs], rank[..., -1]
