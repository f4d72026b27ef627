"""Tests of the port that need a CUDA card: its kernels against their plain
PyTorch versions.  They skip without a card.

This file imports no JAX, so it also runs on a machine without it::

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from lcqpow_tpu_torch.ops import gj_inverse as pgj


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _scaled_spd(B, m, seed, sparse=False, negate=False):
    """Jacobi-scaled SPD batch.  ``sparse`` zeroes about 3/4 of the factor's
    entries and turns half of the resulting exact zeros into -0;
    ``negate`` makes the matrices negative definite (negative pivots)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    if sparse:
        A *= rng.random(size=A.shape) < 0.25
    S = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    d = np.sqrt(np.einsum("bii->bi", S))
    S = (S / (d[:, :, None] * d[:, None, :])).astype(np.float32)
    if negate:
        S = -S
    if sparse:
        S[(S == 0) & (rng.random(size=S.shape) < 0.5)] = -0.0
    return torch.from_numpy(S)


def _same_bits(K, P):
    return torch.equal(K.view(torch.int32), P.view(torch.int32))


# Every order, at a batch (389, prime) that is a multiple of neither the
# matrices per warp (floor(32/m), m <= 32) nor the matrices per block, plus
# the solver's shapes and the largest order.
@pytest.mark.gpu
@pytest.mark.parametrize("B,m", [(4096, 8), (4096, 14), (4095, 14),
                                 (512, 48), (7, 1), (3, 33)]
                         + [(389, m) for m in range(1, 49)])
def test_gj_kernel_matches_plain_on_card(B, m):
    _card()
    S = _scaled_spd(B, m, seed=B + m).cuda()
    before = pgj.launch_count
    K = pgj.gj_inverse(S)
    P = pgj.gj_inverse_plain(S)
    torch.cuda.synchronize()
    assert pgj.launch_count == before + 1
    # Same IEEE f32 operations in the same order (--fmad=false): bitwise.
    assert torch.equal(K, P)
    assert _same_bits(K, P)


# Exact zeros, -0 and negative pivots: the kernel keeps only the signs of
# the identity's zeros (csrc/gj_inverse.cu), and these inputs make the plain
# version produce -0 entries that a kernel writing +0 would miss.
@pytest.mark.gpu
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("m", [2, 5, 8, 14, 31, 32, 40])
def test_gj_kernel_keeps_signed_zeros_on_card(m, negate):
    _card()
    S = _scaled_spd(389, m, seed=m, sparse=True, negate=negate).cuda()
    K = pgj.gj_inverse(S)
    P = pgj.gj_inverse_plain(S)
    torch.cuda.synchronize()
    assert _same_bits(K, P)


# Base pointers that allow no vector load (4-byte offset into storage).
@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 14, 16])
def test_gj_kernel_on_misaligned_input_on_card(m):
    _card()
    S = _scaled_spd(389, m, seed=m).cuda()
    flat = torch.empty(S.numel() + 1, device="cuda")
    Sm = flat[1:].view_as(S)
    Sm.copy_(S)
    assert Sm.is_contiguous() and Sm.data_ptr() % 8 == 4
    assert _same_bits(pgj.gj_inverse(Sm), pgj.gj_inverse_plain(S))


@pytest.mark.gpu
def test_gj_kernel_rejects_what_it_does_not_take():
    _card()
    S = _scaled_spd(8, 14, seed=0).cuda()
    before = pgj.launch_count
    for bad in (S.double(), S[::2], S[0], S[:, :, :13],
                _scaled_spd(2, 49, seed=1).cuda()):
        with pytest.raises(ValueError):
            pgj.gj_inverse(bad)
    assert pgj.launch_count == before
    assert pgj.gj_inverse(S[:0]).shape == (0, 14, 14)


@pytest.mark.gpu
def test_gj_kernel_counts_launches_by_order():
    _card()
    before = dict(pgj.launch_counts)
    for m in (8, 14, 14):
        pgj.gj_inverse(_scaled_spd(5, m, seed=m).cuda())
    assert pgj.launch_counts[8] == before.get(8, 0) + 1
    assert pgj.launch_counts[14] == before.get(14, 0) + 2


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,dtype", [(32, 288, torch.float32),
                                       (3, 202, torch.float32),
                                       (2, 100, torch.float64),
                                       (1, 65, torch.float32)])
def test_sweep_graph_equals_eager(B, n, dtype):
    # The sweep inverse replays a CUDA graph on the card; it must give the
    # bits of the same sweep run eagerly, on a fresh shape and on a replay.
    _card()
    from lcqpow_tpu_torch.ops import chol

    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(B, n, n))
        M = torch.from_numpy(A @ A.transpose(0, 2, 1) / n + np.eye(n)).to(
            dtype).cuda()
        got = chol.sweep_spd_inverse(M)
        want = chol._sweep_eager(M, 32)
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert (tuple(M.shape), dtype, M.device, 32) in chol._SWEEP_GRAPHS
