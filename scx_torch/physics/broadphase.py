"""Broadphase: masked all-pairs AABB overlap with fixed-capacity pair
compaction (port of scx.physics.broadphase).

scx recovers ranks block by block because scatters are slow on a TPU;
here a prefix sum gives each valid entry its rank and one index write puts
it in its slot. The output is identical.
"""

from __future__ import annotations

import torch

from scx_torch.physics.rigid import RigidBodies, body_aabbs


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


def broadphase_pairs(bodies: RigidBodies, max_pairs: int, margin: float = 0.02):
    """Up to `max_pairs` overlapping body pairs per scene of bodies
    [E, N]: (ia, ib [E, P] i32, valid [E, P] bool, n_candidates [E] i32),
    the candidate count taken before the capacity cap (callers report
    max(0, n_candidates - max_pairs) as pair overflow).

    Pairs i < j in flat (i, j) order. Inactive bodies, static-static pairs
    and filtered layers ((a.layer & b.mask) and (b.layer & a.mask)) are
    left out."""
    lo, hi = body_aabbs(bodies)
    return aabb_pairs((lo - margin).unbind(-1), (hi + margin).unbind(-1), bodies.inv_mass,
                      bodies.layer, bodies.mask, bodies.active, max_pairs)


def aabb_pairs(lo, hi, inv_mass, layer, mask, active, max_pairs: int):
    """broadphase_pairs from the bodies' AABBs: lo / hi the three per-axis
    bounds [E, N] (margin included); the conventional and the planar
    broadphase both end here."""
    n = inv_mass.shape[-1]

    def outer(f, a, c):
        return f(a[..., :, None], c[..., None, :])

    overlap = torch.ones((), dtype=torch.bool, device=inv_mass.device)
    for l, h in zip(lo, hi):
        overlap = overlap & outer(torch.le, l, h) & outer(torch.ge, h, l)
    dyn = inv_mass > 0
    layer_ok = (outer(torch.bitwise_and, layer, mask) != 0) & (
        outer(torch.bitwise_and, mask, layer) != 0
    )
    upper = torch.ones((n, n), dtype=torch.bool, device=overlap.device).triu(1)
    valid = (
        overlap
        & outer(torch.logical_or, dyn, dyn)
        & layer_ok
        & outer(torch.logical_and, active, active)
        & upper
    ).reshape(overlap.shape[:-2] + (n * n,))
    kflat, n_valid = compact_flat_indices(valid, max_pairs)
    ia = kflat // n
    ib = kflat - ia * n
    val = torch.arange(max_pairs, device=ia.device) < n_valid[..., None]
    return ia, ib, val, n_valid
