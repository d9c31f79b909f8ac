"""Pytrees of tensors: nested dataclasses, dicts, tuples and lists (named
tuples such as V3 and Q4 included), the port's counterpart of
jax.tree_util's map and leaves. Leaves that are not tensors are kept as
they are."""

from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import torch


def tree_map(fn, *trees):
    """fn over the tensors of one or more pytrees of one structure, into a
    new tree of the first one's structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if is_dataclass(first) and not isinstance(first, type):
        return replace(first, **{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                                 for f in fields(first)})
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return first


def tree_leaves(tree) -> list:
    """The tensors of a pytree, in tree_map's order."""
    out = []

    def visit(t):
        out.append(t)
        return t

    tree_map(visit, tree)
    return out
