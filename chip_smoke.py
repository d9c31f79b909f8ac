#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Run from the root of the repository. It drives the port's main path, the
batched physics fleet step (1024 scenes x 64 bodies, max_pairs=128,
6 solver iterations, box-only narrowphase), in phases and exits non-zero
at the first failure:

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the port's CUDA sources (scx_torch/physics/csrc);
  3. kernel vs plain: the middle kernel against its plain PyTorch version
     on the card, (a) at the main shape after 3 warm steps, (b) on a
     64 x 24 fleet of boxes, spheres and capsules;
  4. main path: a 240-step rollout through the kernel, which must launch
     it once per step, overflow no pair list and keep every state finite;
     then 20 steps of the plain path for its rate, whose positions 99% of
     the envs must match within 1e-5 after 20 kernel-path steps.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

ENVS, BODIES, STEPS, PLAIN_STEPS = 1024, 64, 240, 20
# the contract of scx's fused-kernel test (tests/test_physics_planar.py):
# validity may differ only at graze depth; cand exact where both are
# valid; trig exact; vwc within 5e-5; lam within 5e-4
GRAZE, VWC_TOL, LAM_TOL = 1e-5, 5e-5, 5e-4


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_middle(tag, b, params, steps):
    """Kernel vs plain middle on the card after `steps` warm steps."""
    import torch

    from scx_torch.physics import planar as pp

    cache = pp.empty_planar_cache(b.shape.shape[0], params.max_pairs,
                                  device=b.shape.device)
    for _ in range(steps):
        b, cache, _ = pp.step_planar_cached(b, params, cache)
    _, ops, _ = pp.middle_operands(b, params, cache)
    ker = [x.cpu() for x in pp.middle(*ops, params)]  # .cpu() waits for the kernel
    ref = [x.cpu() for x in pp.middle_reference(*ops, params)]
    vwc_k, lam_k, cand_k, val_k, trig_k = ker
    vwc_r, lam_r, cand_r, val_r, trig_r = ref
    flips = val_k != val_r
    if flips.any():
        rows, ia, ib, pvf = ops[:4]
        depth = pp._sat_top_k(pp._gather(rows, ia.long()), pp._gather(rows, ib.long()),
                              pvf > 0.5, params.shape_kinds)[2]
        worst = torch.stack(depth, dim=-2).abs().cpu()[flips].max().item()
        if worst >= GRAZE:
            fail(f"{tag}: validity differs at depth {worst}")
    both = (val_k > 0.5) & (val_r > 0.5)
    err_vwc = (vwc_k - vwc_r).abs().max().item()
    err_lam = (lam_k - lam_r).abs().max().item()
    rec = {
        "check": tag, "envs": b.shape.shape[0], "bodies": b.n, "pairs": params.max_pairs,
        "kinds": list(params.shape_kinds), "valid_contacts": int(both.sum()),
        "validity_flips": int(flips.sum()),
        "cand_mismatch": int((cand_k[both] != cand_r[both]).sum()),
        "trig_mismatch": int((trig_k != trig_r).sum()),
        "vwc_max_abs_err": err_vwc, "lam_max_abs_err": err_lam,
    }
    print(json.dumps(rec), flush=True)
    if int(both.sum()) == 0:
        fail(f"{tag}: no live contacts to compare")
    if rec["cand_mismatch"] or rec["trig_mismatch"]:
        fail(f"{tag}: discrete outputs differ")
    if not (err_vwc <= VWC_TOL and err_lam <= LAM_TOL):
        fail(f"{tag}: vwc err {err_vwc} (tol {VWC_TOL}), lam err {err_lam} (tol {LAM_TOL})")
    return ops, max(err_vwc, err_lam)


def main():
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from scx_torch.physics import _build, fleet
    from scx_torch.physics import planar as pp
    from scx_torch.physics.solver import SolverParams

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"# build {time.perf_counter() - t0:.1f} s -> {_build.library_path()}", flush=True)
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():  # registers and spills per kernel
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print("# " + line.strip(), flush=True)

    # ---- 3. kernel vs plain ----------------------------------------------
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    ops, err_main = check_middle("main", fleet.build_pile_fleet(ENVS, BODIES, dev), params, 3)
    kernel_ms = cuda_ms(lambda: pp.middle(*ops, params), 20)
    plain_ms = cuda_ms(lambda: pp.middle_reference(*ops, params), 3)
    print(json.dumps({"middle_ms": kernel_ms, "middle_plain_ms": plain_ms,
                      "envs": ENVS, "bodies": BODIES, "pairs": 128, "card": card}), flush=True)
    mixed = SolverParams(max_pairs=128, iterations=6)
    check_middle("mixed", fleet.build_mixed_fleet(64, 24, 5, dev), mixed, 3)

    # ---- 4. the main path ------------------------------------------------
    def run(middle_fn, steps):
        b = fleet.build_pile_fleet(ENVS, BODIES, dev)
        cache = pp.empty_planar_cache(ENVS, params.max_pairs, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b, cache, ovf = fleet.rollout(b, cache, params, steps, middle_fn=middle_fn)
        torch.cuda.synchronize()
        ovf = int(ovf.item())
        return b, ovf, time.perf_counter() - t

    pp.MIDDLE_KERNEL_LAUNCHES = 0
    b, ovf, secs = run(pp.middle, STEPS)
    launches = pp.MIDDLE_KERNEL_LAUNCHES
    finite = all(
        torch.isfinite(x).all().item()
        for x in (*b.pos, *b.quat, *b.vel, *b.omega)
    )
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "cuda-kernel",
                      "value": ENVS * STEPS / secs, "envs": ENVS, "bodies": BODIES,
                      "steps": STEPS, "seconds": secs, "card": card}), flush=True)
    if launches != STEPS:
        fail(f"the main path launched the middle kernel {launches} times in {STEPS} steps")
    if ovf != 0:
        fail(f"pair overflow {ovf} in the main path")
    if not finite or tuple(b.pos.y.shape) != (ENVS, BODIES):
        fail("the main path's state is not finite or has the wrong shape")
    b_plain, _, secs_plain = run(pp.middle_reference, PLAIN_STEPS)
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "plain-torch",
                      "value": ENVS * PLAIN_STEPS / secs_plain, "envs": ENVS,
                      "bodies": BODIES, "steps": PLAIN_STEPS, "seconds": secs_plain,
                      "card": card}), flush=True)
    # the two paths' trajectories from the same fleet
    b_kern, _, _ = run(pp.middle, PLAIN_STEPS)
    dev_env = torch.stack([(x - y).abs() for x, y in zip(b_kern.pos, b_plain.pos)]).amax((0, 2))
    print(json.dumps({"check": "trajectory", "steps": PLAIN_STEPS,
                      "pos_max_abs_diff": dev_env.max().item(),
                      "envs_within_1e-5": (dev_env <= 1e-5).float().mean().item(),
                      "envs_within_1e-3": (dev_env <= 1e-3).float().mean().item()}), flush=True)
    # the paths agree bit for bit where no contact flips; leave room for a
    # rare graze flip, which moves one env's trajectory
    if (dev_env <= 1e-5).float().mean().item() < 0.99:
        fail("the kernel path's trajectory departs from the plain path's")

    # ---- 5. records ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "planar_middle", "route": "cuda",
        "source": "scx_torch/physics/csrc/planar_middle.cu",
        "replaces": "scx/physics/planar.py:1786",
        "launches": launches, "max_abs_err": err_main,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
