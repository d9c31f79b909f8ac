"""Contact warm starting: accumulated impulses carried across steps (port
of scx.physics.warmstart).

A fixed-shape cache per scene, keyed by pair identity:

  * a pair's key is (key_a, key_b): its bodies' row indices, or, when the
    caller passes `key_id`, a persistent per-body id column, so the cache
    survives row reshuffling (migration between strips, ghost churn);
  * this step's pairs find last step's by key equality; keys are unique,
    so a pair matches at most one stored pair;
  * within a pair, contacts keep their candidate-slot id (face-A corner k,
    face-B corner k, edge end k), and a contact takes the impulses of the
    stored contact with the same id;
  * keys match only in the same (A, B) role order: a pair whose roles
    flipped cold-starts for a step rather than taking sign-flipped
    impulses.

scx matches keys with a one-hot [P, P] matmul and candidate slots with a
[P, K, K] one-hot, for the TPU's matrix unit. Here the match is an index
found by comparison, then a gather: the same selection, bit for bit.
Tensors carry the fleet's env axis: [E, P], [E, P, K], [E, P, 3 K].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scx_torch import resolve_device
from scx_torch.physics.contacts import MAX_CONTACTS_PER_PAIR

_EMPTY = -1


@dataclass
class ContactCache:
    """Per-scene warm-start caches, fixed capacity [E, max_pairs]."""

    key_a: torch.Tensor  # [E, P] i32 stable id of body A (-1 empty slot)
    key_b: torch.Tensor  # [E, P] i32 stable id of body B (-1 empty slot)
    cand: torch.Tensor   # [E, P, K] i32 candidate slot per stored contact (-1 none)
    lam: torch.Tensor    # [E, P, 3 K] f32 accumulated (ln, l1, l2) per contact


def empty_contact_cache(envs: int, max_pairs: int, k: int = MAX_CONTACTS_PER_PAIR,
                        device=None) -> ContactCache:
    """An empty cache for `envs` scenes on `device` (the card by default)."""
    device = resolve_device(device)
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    return ContactCache(
        key_a=full((envs, max_pairs), _EMPTY, torch.int32),
        key_b=full((envs, max_pairs), _EMPTY, torch.int32),
        cand=full((envs, max_pairs, k), -1, torch.int32),
        lam=full((envs, max_pairs, k * 3), 0.0, torch.float32),
    )


def _pair_keys(ia, ib, pair_valid, key_id=None):
    """(key_a, key_b) [E, P] of this step's pairs: body indices, or key_id
    [E, N] (an integer gather, so uids past 2^24 stay exact); -1 where
    invalid. The planar step's cache takes the same keys."""
    if key_id is None:
        ka, kb = ia, ib
    else:
        ka = torch.gather(key_id, -1, ia.long())
        kb = torch.gather(key_id, -1, ib.long())
    ka = torch.where(pair_valid, ka, _EMPTY).to(torch.int32)
    kb = torch.where(pair_valid, kb, _EMPTY).to(torch.int32)
    return ka, kb


def key_match(ka, kb, pair_valid, key_a_old, key_b_old):
    """Each of this step's pairs [E, P] against the stored pairs [E, P
    old]: (hit [E, P] bool, the stored slot j [E, P] where hit). Keys are
    unique, so a pair matches at most one stored pair; the planar step's
    warm start matches the same way."""
    match = (
        (ka[..., :, None] == key_a_old[..., None, :])
        & (kb[..., :, None] == key_b_old[..., None, :])
        & pair_valid[..., :, None]
        & (key_a_old != _EMPTY)[..., None, :]
    )
    return match.any(-1), match.to(torch.int32).argmax(-1)


def gather_warm_impulses(cache: ContactCache, ia, ib, pair_valid, cand, n_bodies=None,
                         key_id=None):
    """Warm impulses [E, P K, 3] of this step's contacts (zeros where
    unmatched).

    ia / ib / pair_valid: this step's pairs [E, P]; cand [E, P K]: the
    candidate slots from generate_contacts; key_id: an optional [E, N]
    stable per-body id (row indices when None). n_bodies is unused, as in
    scx."""
    del n_bodies
    e, p = ia.shape
    k = MAX_CONTACTS_PER_PAIR
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    hit, j = key_match(ka, kb, pair_valid, cache.key_a, cache.key_b)
    old = lambda x: torch.gather(x, 1, j[..., None].expand(e, p, x.shape[-1]))
    prev_lam = torch.where(hit[..., None], old(cache.lam), 0.0).reshape(e, p, k, 3)
    prev_cand = torch.where(hit[..., None], old(cache.cand), -1)           # [E, P, K]
    cur_cand = cand.reshape(e, p, k)
    # re-associate by candidate slot: stored slot t feeds the current slot
    # with the same id
    lam0 = torch.zeros_like(prev_lam)
    for t in range(k):
        pc = prev_cand[..., t:t + 1]
        m = (cur_cand == pc) & (pc >= 0)                       # [E, P, K]
        lam0 = lam0 + torch.where(m[..., None], prev_lam[..., t:t + 1, :], 0.0)
    return lam0.reshape(e, p * k, 3)


def store_impulses(cache: ContactCache, ia, ib, pair_valid, cand, lam, contact_valid,
                   n_bodies=None, key_id=None) -> ContactCache:
    """The new cache from this step's solve (lam [E, P K, 3])."""
    del n_bodies
    e, p = ia.shape
    k = MAX_CONTACTS_PER_PAIR
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    lam_masked = torch.where(contact_valid[..., None], lam, 0.0).reshape(e, p, k * 3)
    cand_masked = torch.where(contact_valid, cand, -1).reshape(e, p, k)
    return ContactCache(key_a=ka, key_b=kb, cand=cand_masked.to(torch.int32),
                        lam=lam_masked.to(torch.float32))
