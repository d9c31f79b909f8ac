"""The least time an H100 could take for a kernel's work, counted from its
inputs: the larger of the bytes it must move over HBM bandwidth and the
operations it must do over the FP32 peak. The byte counts follow
chip_smoke.py's (`middle_bound`, `staged_bounds`); the operations are those
of the plain reference (reference/pile64.py) on the same step, counted as it
runs and scaled to the pairs and contacts that exist, so that a change to
the program moves neither the work counted nor the peaks."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM3 bytes/s, FP32 flop/s
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12
F32 = 4  # bytes of each value the kernels read or write
K = 4    # contact slots per pair in the program's operands
# rows of the program's operands: the fused middle's per-body rows, the SAT's
# per-body rows, the solve pack's rows per pair, and the warm-start record
MIDDLE_ROWS, SAT_ROWS, SOLVE_ROWS, PREV_ROWS = 21, 14, 168, 4 * K

_ARITH = {
    "add", "sub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "reciprocal", "maximum",
    "minimum", "clamp", "clamp_min", "clamp_max", "where", "gt", "lt", "ge", "le", "eq",
    "ne", "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "sum", "amax", "amin", "max", "min", "argmax", "argmin",
    "sin", "cos", "floor", "ceil", "sign", "pow", "exp", "log", "log2", "atan2",
    "cumsum", "mean", "prod", "fmod", "remainder", "lerp", "addcmul", "addcdiv",
}


def bound(bytes_moved: float, ops: float):
    """(least ms the card could take, what bounds it: "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def count_ops(fn) -> int:
    """Arithmetic operations one call of `fn` performs, counted as it runs:
    one per output element of each elementwise op, one per input element
    of each reduction."""

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in _ARITH:
                flat = list(args) + list(kwargs.values() if kwargs else []) + [out]
                flat += list(out) if isinstance(out, (tuple, list)) else []
                Counter.ops += max((x.numel() for x in flat if isinstance(x, torch.Tensor)),
                                   default=0)
            return out

    with Counter():
        fn()
    return Counter.ops


def middle_bound(w: dict):
    """(bound ms, by) of the fused middle on one step's work `w` (see
    configs/pile64.py `Pile.probe`). Bytes: the pair indices, validity and
    velocities and every output once; the body rows of the bodies in pairs
    and the warm-start record of the pairs; operations: the reference's
    narrowphase per pair and its solve per contact."""
    e, n, p = w["envs"], w["bodies"], w["slots"]
    nbytes = F32 * (3 * e * p + 6 * e * n + 7 * e * n + 3 * K * e * p + 3 * K * e * p
                    + MIDDLE_ROWS * w["pair_bodies"] + PREV_ROWS * w["pairs"])
    return bound(nbytes, w["narrow_ops"] + w["setup_ops"] + w["sweep_ops"])


def sat_bound(w: dict):
    """(bound ms, by) of the staged SAT kernel: the pair validity, the body
    rows of each pair's two bodies, every output once; the reference's
    narrowphase per pair."""
    e, p = w["envs"], w["slots"]
    nbytes = F32 * (e * p + 2 * SAT_ROWS * w["pairs"] + 9 * K * e * p + 3 * e * p)
    return bound(nbytes, w["narrow_ops"])


def solve_bound(w: dict):
    """(bound ms, by) of the staged solve kernel: of the pack, every slot's
    validity and impulses and the rest of the pairs with a contact; the pair
    indices, velocities in and out and the impulses out; the reference's
    sweeps per contact."""
    e, n, p = w["envs"], w["bodies"], w["slots"]
    pack = e * p * PREV_ROWS + (SOLVE_ROWS - PREV_ROWS) * w["live_pairs"]
    nbytes = F32 * (pack + 2 * e * p + 12 * e * n + 3 * K * e * p)
    return bound(nbytes, w["sweep_ops"])
