"""Simulation checkpoint / resume (port of scx.app.checkpoint), in scx's
file format.

The reference has no runtime save-game — persistence is only the authored
sector files (SURVEY §5.4). Here the whole simulation state of one world is
one dataclass tree of tensors, so a checkpoint is one .npz of its columns
keyed by dataclass path ("transform.pos", "body.layer", ...) plus a .json
of meta data (`format` 1, `capacity`, `extra`), exactly as scx writes them:

  * the port's env axis is dropped on save and added on load (a checkpoint
    holds one world, [C, ...] columns, as scx's does);
  * the port's int64 columns, which hold scx's uint32 bits, are written as
    uint32 and read back into int64.

So a save written by scx loads here and one written here loads into scx.
`load_legacy_contact_cache` converts scx's pre-planar warm-start cache
saves (the conventional step's ContactCache layout) into a PlanarCache.
"""

from __future__ import annotations

import json
import os
from dataclasses import fields, is_dataclass, replace

import numpy as np
import torch

from scx_torch.state import entity as ent

_FORMAT_VERSION = 1


def _flatten(tree) -> dict:
    """{dotted path: numpy array} of a one-world tree ([1, ...] tensors),
    the env axis dropped and int64 columns as uint32."""
    leaves = {}

    def visit(prefix, node):
        if is_dataclass(node):
            for f in fields(node):
                visit(f"{prefix}{f.name}.", getattr(node, f.name))
            return
        if node.shape[0] != 1:
            raise ValueError(f"a checkpoint holds one world; {prefix[:-1]} has "
                             f"{node.shape[0]} envs")
        a = node[0].detach().cpu().numpy()
        if a.dtype == np.int64:
            a = (a & ent.U32).astype(np.uint32)
        leaves[prefix[:-1]] = a

    visit("", tree)
    return leaves


def _rebuild(template, data, require_all: bool):
    """template's tree with each leaf read from data (env axis added, on
    the template leaf's device and dtype). A leaf missing from data keeps
    the template's value unless require_all; None if a required leaf is
    missing or a shape disagrees."""

    def visit(prefix, node):
        if is_dataclass(node):
            out = {}
            for f in fields(node):
                v = visit(f"{prefix}{f.name}.", getattr(node, f.name))
                if v is None:
                    return None
                out[f.name] = v
            return replace(node, **out)
        key = prefix[:-1]
        if key not in data:
            return None if require_all else node
        a = data[key]
        if a.shape != tuple(node.shape[1:]):
            return None
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a))[None].to(node.device, node.dtype)

    return visit("", template)


def save_aux_pytree(path: str, tree) -> None:
    """Serialize any one-world dataclass tree (e.g. the solver's warm-start
    PlanarCache) to <path>.npz alongside a checkpoint."""
    np.savez_compressed(path + ".npz", **_flatten(tree))


def load_aux_pytree(path: str, template):
    """Rebuild a tree saved by save_aux_pytree onto `template`'s structure
    and device. Returns None when the file is missing or any leaf's shape
    disagrees with the template (e.g. the solver capacity was retuned since
    the save) — callers keep their fresh template in that case."""
    try:
        data = np.load(path + ".npz")
    except OSError:
        return None
    return _rebuild(template, data, require_all=True)


def save_checkpoint(path: str, state: ent.EntityState, extra: dict | None = None):
    """Write one world's sim state (+ optional host bookkeeping dict) to
    <path>.npz/.json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path + ".npz", **_flatten(state))
    meta = {
        "format": _FORMAT_VERSION,
        "capacity": int(state.capacity),
        "extra": extra or {},
    }
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh)
    return True


def load_checkpoint(path: str, device=None):
    """Returns (EntityState [1, C] on `device`, the card by default; extra
    dict) or None."""
    try:
        with open(path + ".json") as fh:
            meta = json.load(fh)
        data = np.load(path + ".npz")
    except OSError:
        return None
    if meta.get("format") != _FORMAT_VERSION:
        return None
    template = ent.alloc_entity_state(meta["capacity"], envs=1, device=device)
    # a leaf added after the checkpoint was written (same format version)
    # keeps the freshly-allocated default, so old saves stay loadable
    state = _rebuild(template, data, require_all=False)
    if state is None:
        return None
    return state, meta.get("extra", {})


def load_legacy_contact_cache(path: str, max_pairs: int, device=None):
    """A pre-planar ContactCache aux save (key_a / key_b [P], cand [P, K],
    lam [P, 3 K] with (ln, l1, l2) minor) as the PlanarCache plane layout
    ([1, K, P] planes, the lam components split) on `device` (the card
    by default), so such save-games resume warm. None when `path` is not a
    legacy-layout save of this capacity."""
    from scx_torch import resolve_device
    from scx_torch.physics.planar import PlanarCache

    try:
        data = np.load(path + ".npz")
    except OSError:
        return None
    if set(data.files) != {"key_a", "key_b", "cand", "lam"}:
        return None
    ka, kb = data["key_a"], data["key_b"]
    cand, lam = data["cand"], data["lam"]
    if (
        ka.shape != (max_pairs,)
        or cand.ndim != 2
        or cand.shape[0] != max_pairs
        or lam.shape != (max_pairs, cand.shape[1] * 3)
    ):
        return None
    lam3 = lam.reshape(max_pairs, cand.shape[1], 3)
    device = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None].to(device)
    return PlanarCache(key_a=t(ka), key_b=t(kb), cand=t(cand.T), lam_n=t(lam3[..., 0].T),
                       lam_1=t(lam3[..., 1].T), lam_2=t(lam3[..., 2].T))
