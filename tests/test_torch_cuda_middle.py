"""The CUDA middle kernel against its plain PyTorch version, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_middle.py
The contract is that of tests/test_torch_planar_middle.py."""

from dataclasses import replace

import pytest
import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams

pytestmark = pytest.mark.cuda
ALL_KINDS = ("box", "sphere", "capsule")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the middle kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", [
    (64, 24, 128, ALL_KINDS, False),
    (16, 24, 37, ALL_KINDS, True),
    (128, 64, 128, ("box",), False),
    (8, 64, 256, ("box",), False),
    (8, 512, 128, ("box",), False),
])
def test_kernel_matches_plain(gpu, envs, bodies, pairs, kinds, triggers):
    params = SolverParams(max_pairs=pairs, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(envs, bodies, gpu)
    else:
        b = fleet.build_mixed_fleet(envs, bodies, 5, gpu)
    if triggers:
        b = replace(b, trigger=(torch.arange(bodies, device=gpu) % 7 == 3).expand(envs, -1))
    cache = tp.empty_planar_cache(envs, pairs, device=gpu)
    for _ in range(3):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    _, ops, _ = tp.middle_operands(b, params, cache)
    before = tp.MIDDLE_KERNEL_LAUNCHES
    ker = [x.cpu() for x in tp.middle(*ops, params)]
    assert tp.MIDDLE_KERNEL_LAUNCHES == before + 1
    ref = [x.cpu() for x in tp.middle_reference(*ops, params)]
    vwc_k, lam_k, cand_k, val_k, trig_k = ker
    vwc_r, lam_r, cand_r, val_r, trig_r = ref
    flips = val_k != val_r
    if flips.any():
        rows, ia, ib, pvf = ops[:4]
        depth = tp._sat_top_k(tp._gather(rows, ia.long()), tp._gather(rows, ib.long()),
                              pvf > 0.5, kinds)[2]
        assert torch.stack(depth, -2).abs().cpu()[flips].max() < 1e-5
    both = (val_k > 0.5) & (val_r > 0.5)
    assert both.sum() > 0
    assert torch.equal(cand_k[both], cand_r[both])
    assert torch.equal(trig_k, trig_r)
    if triggers:
        assert trig_r.sum() > 0
    torch.testing.assert_close(vwc_k, vwc_r, rtol=0, atol=5e-5)
    torch.testing.assert_close(lam_k, lam_r, rtol=0, atol=5e-4)


def test_kernel_rejects_bad_operands(gpu):
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(4, 64, gpu)
    _, ops, _ = tp.middle_operands(b, params, tp.empty_planar_cache(4, 128, device=gpu))
    bad = list(ops)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError):
        tp.middle(*bad, params)
    bad = list(ops)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        tp.middle(*bad, params)
    wide = SolverParams(max_pairs=2048, iterations=6, shape_kinds=("box",))
    _, ops, _ = tp.middle_operands(b, wide, tp.empty_planar_cache(4, 2048, device=gpu))
    with pytest.raises(ValueError, match="cannot take"):
        tp.middle(*ops, wide)
