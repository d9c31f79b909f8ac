"""The rest of a run on the CPU at a size a test run can hold (the look for
a card skipped): sound runs come out correct, a run with the timed path
broken underneath comes out not correct once for each fault a cell can
have, and so does the control in the program's place."""

import time

import pytest
import torch

from portbench import compare, run

CPU = torch.device("cpu")
MANIFEST = run.load_manifest()
SIZES = {"pile64": {"envs": 4, "chunk_steps": 2}}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def one_run(cell, seed=2**31 + 3, **kw):
    cfg = run.cell_of(MANIFEST, cell)["config"]
    return run.run_cell(MANIFEST, cell, seed, 0.3, False, CPU, time.perf_counter(),
                        log=lambda m: None, resize=SIZES[cfg], **kw)


def envs_where(mask_fn, new, old):
    """new where mask_fn(leaf) selects an env, else old, leaf by leaf."""
    from scx_torch.core.tree import tree_map

    def pick(n, o):
        keep = mask_fn(n.shape[0], n.device).reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(keep, n, o)

    return tree_map(pick, new, old)


def first_half(e, dev):
    return torch.arange(e, device=dev) < e // 2


# each fault: (what it breaks, a wrapper of the step)
def pile_unchanged(step):
    def f(b, params, cache, *a, **k):
        _, _, stats = step(b, params, cache, *a, **k)
        return b, cache, stats
    return f


def pile_half(step):
    def f(b, params, cache, *a, **k):
        nb, nc, stats = step(b, params, cache, *a, **k)
        return envs_where(first_half, nb, b), envs_where(first_half, nc, cache), stats
    return f


def pile_altered(step):
    def f(b, params, cache, *a, **k):
        nb, nc, stats = step(b, params, cache, *a, **k)
        vx = nb.vel.x.clone()
        vx[0, 5] += 0.05
        return type(nb)(**{**nb.__dict__, "vel": nb.vel._replace(x=vx)}), nc, stats
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = one_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in MANIFEST["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [pile_unchanged, pile_half, pile_altered])
@pytest.mark.parametrize("cell,name", [("pile64.drop", "step_planar_cached"),
                                       ("pile64.staged", "step_planar_staged")])
def test_pile_faults_are_not_correct(monkeypatch, cell, name, fault):
    from scx_torch.physics import planar

    monkeypatch.setattr(planar, name, fault(getattr(planar, name)))
    assert not one_run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = one_run(cell, with_control=True)
    checks = [c for c in compare.judge(cell, out["control"]) if c.name in out["control"]]
    assert checks and not all(c.ok for c in checks), out["control"]
