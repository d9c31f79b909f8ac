"""The CUDA key-match kernel (planar._warm_prev) against its plain PyTorch
version, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_warm.py
The kernel is a selection: its record equals warm_prev_reference's bit for
bit, as in tests/test_torch_warm_emulated.py."""

import pytest
import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams

import torch_planar_emu

pytestmark = pytest.mark.cuda
PILE = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the key-match kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _check(cache, ka, kb, pair_valid):
    """One launch of the kernel, equal to the plain version bit for bit;
    returns the plain record."""
    before = tp.WARM_KERNEL_LAUNCHES
    got = tp._warm_prev(cache, ka, kb, pair_valid)
    assert tp.WARM_KERNEL_LAUNCHES == before + 1
    want = tp.warm_prev_reference(cache, ka, kb, pair_valid)
    assert torch_planar_emu.warm_bits_equal(got.cpu(), want.cpu())
    return want


@pytest.mark.parametrize("key_id", [False, True])
def test_warm_kernel_matches_plain_on_a_pile_rollout(gpu, key_id):
    """The cache of a real 20-step rollout of the pile at 1,024 envs, keys
    by body index and by uids past 2^24."""
    envs = 1024
    b = fleet.build_pile_fleet(envs, 64, gpu)
    cache = tp.empty_planar_cache(envs, PILE.max_pairs, device=gpu)
    kid = None
    if key_id:
        kid = (2**24 + 3 * torch.arange(envs * 64, dtype=torch.int32, device=gpu)).view(envs, 64)
    for _ in range(20):
        b, cache, _ = tp.step_planar_cached(b, PILE, cache, kid)
    b = tp.planar_integrate_velocities(b, PILE.dt, PILE.gravity)
    ia, ib, pair_valid, _ = tp.planar_broadphase(b, PILE.max_pairs)
    ka, kb = tp._pair_keys(ia, ib, pair_valid, kid)
    want = _check(cache, ka, kb, pair_valid)
    assert (want[:, :4] > 0).sum() > envs  # most envs carry matched pairs


@pytest.mark.parametrize("envs,pairs,pairs_old,keys", [
    (4, 2048, 2048, "uids"), (4, 2048, 2048, "rows"), (64, 256, 256, "uids"),
    (3, 256, 1100, "rows"), (1, 100, 37, "uids"),
])
def test_warm_kernel_matches_plain_on_random_caches(gpu, envs, pairs, pairs_old, keys):
    """The big scene's shape (4 x 2,048) and others, on warm_case's caches:
    hits, misses, empty slots, duplicates, invalid pairs with stored keys."""
    cache, *keys_valid = torch_planar_emu.warm_case(envs, pairs, keys, pairs_old, device=gpu)
    want = _check(cache, *keys_valid)
    torch_planar_emu.check_warm_case(tp.map_tensors(lambda x: x.cpu(), cache),
                                     *(x.cpu() for x in keys_valid), want.cpu())


@pytest.mark.parametrize("step", [tp.step_planar_cached, tp.step_planar_staged])
def test_each_route_launches_the_warm_kernel_once_a_step(gpu, step):
    b = fleet.build_pile_fleet(64, 64, gpu)
    cache = tp.empty_planar_cache(64, PILE.max_pairs, device=gpu)
    for _ in range(3):
        before = tp.WARM_KERNEL_LAUNCHES
        b, cache, _ = step(b, PILE, cache)
        assert tp.WARM_KERNEL_LAUNCHES == before + 1


def test_warm_kernel_rejects_bad_operands_and_takes_no_envs(gpu):
    cache, ka, kb, pair_valid = torch_planar_emu.warm_case(2, 128, device=gpu)
    with pytest.raises(ValueError):
        tp._warm_prev(cache, ka.long(), kb, pair_valid)
    with pytest.raises(ValueError):
        tp._warm_prev(cache, ka, kb, pair_valid.float())
    with pytest.raises(ValueError, match="contiguous"):
        tp._warm_prev(cache, ka.t().contiguous().t(), kb, pair_valid)
    with pytest.raises(ValueError):
        tp._warm_prev(tp.map_tensors(lambda x: x[:1], cache), ka, kb, pair_valid)
    empty = tp.empty_planar_cache(0, 128, device=gpu)
    none = torch.zeros(0, 128, dtype=torch.int32, device=gpu)
    prev = tp._warm_prev(empty, none, none, none.bool())
    assert tuple(prev.shape) == (0, 16, 128)
