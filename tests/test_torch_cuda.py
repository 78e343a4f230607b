"""The port's CUDA kernel against its plain PyTorch version, on the card, and
the port's no-fallback device rule.

The kernel tests are marked `cuda` and skip without a GPU. On a machine with
one (which has no JAX, so the JAX test configuration is left out):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports nothing of the JAX package."""

import numpy as np
import pytest
import torch

from dr_slam_torch._smoke import synthetic_matcher_inputs
from dr_slam_torch.ops import match_cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(args):
    before = match_cuda.gated_top2_hamming.launches
    out_k = match_cuda.gated_top2_hamming(*args)
    torch.cuda.synchronize()
    assert match_cuda.gated_top2_hamming.launches == before + 1
    out_r = match_cuda.gated_top2_hamming_ref(*args)
    for name, a, b in zip(("best", "idx", "second", "colk"), out_k, out_r):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                      err_msg=name)
    return out_k


@pytest.mark.cuda
@pytest.mark.parametrize("K,NC,n_valid", [(64, 1024, 600), (1024, 32768, 3000),
                                          (1000, 4608, 4608),
                                          (1000, 32768, 3000)])
def test_kernel_bit_exact_vs_plain(cuda_device, K, NC, n_valid):
    """Bit-exact with ties across tiles (rows) and duplicated keypoints
    (columns), at the main path's shapes and at ragged keypoint counts."""
    args = synthetic_matcher_inputs(K=K, NC=NC, n_valid=n_valid,
                                    n_ties=min(64, K // 4), seed=K + NC)
    best, idx, second, colk = _check(args)
    b, s = best.cpu().numpy(), second.cpu().numpy()
    assert np.isfinite(b).sum() > K // 4
    assert np.any(np.isfinite(b) & (b == s))          # a row tie was hit


@pytest.mark.cuda
@pytest.mark.parametrize("K,NC", [(256, 2048), (1024, 32768)])
def test_kernel_all_dead_tiles(cuda_device, K, NC):
    """No valid candidate at all, at a small and at the main path's shape."""
    args = list(synthetic_matcher_inputs(K=K, NC=NC, n_valid=512, n_ties=0,
                                         seed=3))
    args[9] = torch.zeros_like(args[9])
    best, idx, second, colk = _check(tuple(args))
    assert torch.isinf(best).all() and torch.isinf(second).all()
    assert (idx == 0).all() and (colk == 0).all()


@pytest.mark.cuda
def test_kernel_full_occupancy(cuda_device):
    """All 32768 slots valid: the compaction's full pass, 256 chunks of
    items and 256 partials per keypoint."""
    args = list(synthetic_matcher_inputs(n_valid=32768, seed=12))
    args[9] = torch.ones_like(args[9])
    best, idx, second, colk = _check(tuple(args))
    assert int(torch.isfinite(best).sum()) > 512
    assert int((colk > 0).sum()) > 1000


@pytest.mark.cuda
def test_kernel_valid_candidates_scattered(cuda_device):
    """Live slots spread over every 128-slot tile rather than packed low."""
    args = synthetic_matcher_inputs(n_valid=3000, seed=13)
    perm = torch.from_numpy(np.random.RandomState(13).permutation(32768))
    perm = perm.to(cuda_device)
    args = args[:4] + tuple(a[perm].contiguous() for a in args[4:])
    assert int(args[9].view(-1, 128).any(1).sum()) >= 250
    _check(args)


@pytest.mark.cuda
def test_kernel_row_ties_in_different_chunks(cuda_device):
    """Three copies of one keypoint at compacted positions 3, 140 and 290
    (three chunks of 128): best = second = 0 and the lowest slot wins."""
    args = list(synthetic_matcher_inputs(K=256, NC=4096, n_valid=2000,
                                         n_ties=0, seed=14))
    k = int(torch.nonzero(args[2])[0])
    slots = torch.nonzero(args[9]).flatten()[[3, 140, 290]]
    for c in slots.tolist():
        args[4][c], args[5][c], args[7][c] = args[0][k], args[1][k], args[3][k]
        args[6][c], args[8][c] = 28.0, True
    best, idx, second, colk = _check(tuple(args))
    assert float(best[k]) == 0.0 and float(second[k]) == 0.0
    assert int(idx[k]) == int(slots[0])


@pytest.mark.cuda
def test_kernel_ungated_valid_candidates_keep_colk_zero(cuda_device):
    """Valid candidates that no keypoint gates (far away, or a radius of 0,
    below 0 or NaN, with and without the scale flag) keep colk = 0."""
    args = list(synthetic_matcher_inputs(K=512, NC=4096, n_valid=2000,
                                         n_ties=8, seed=15))
    sel = torch.arange(4096, device=cuda_device) % 5
    args[5] = torch.where((sel == 0)[:, None], torch.full_like(args[5], 1e9),
                          args[5])
    for v, rad in ((1, 0.0), (2, -5.0), (3, float("nan"))):
        args[6] = torch.where(sel == v, torch.full_like(args[6], rad), args[6])
    best, idx, second, colk = _check(tuple(args))
    unreached = args[9] & (sel < 4)
    assert bool(unreached.any()) and bool((colk[unreached] == 0).all())
    assert bool((colk[args[9] & (sel == 4)] > 0).any())


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    args = synthetic_matcher_inputs(K=64, NC=1024, n_valid=300,
                                    n_ties=0, seed=4)
    with pytest.raises(ValueError):
        match_cuda.gated_top2_hamming(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        match_cuda.gated_top2_hamming(*args[:4], args[4][:1000], *args[5:])
    with pytest.raises(ValueError):
        match_cuda.gated_top2_hamming(args[0].cpu(), *args[1:])


def test_entry_points_raise_without_a_gpu():
    """No silent CPU fallback: without a card, `device=None` (the GPU)
    raises; `device="cpu"` is the explicit way to run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dr_slam_torch import resolve_device
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.frontend.frame import extract_frame
    from dr_slam_torch.slam.state import make_empty_state

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_empty_state(tum_freiburg3())
    gray = np.zeros((48, 64), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_frame(gray, np.zeros((48, 64), np.uint16), tum_freiburg3())
    assert resolve_device("cpu").type == "cpu"


def test_cpu_tensors_take_the_plain_matcher():
    args = tuple(t.cpu() for t in synthetic_matcher_inputs(
        K=32, NC=512, n_valid=200, n_ties=4, seed=5, device="cpu"))
    before = match_cuda.gated_top2_hamming.launches
    out = match_cuda.gated_top2_hamming(*args)
    assert match_cuda.gated_top2_hamming.launches == before
    for a, b in zip(out, match_cuda.gated_top2_hamming_ref(*args)):
        assert torch.equal(a, b)
