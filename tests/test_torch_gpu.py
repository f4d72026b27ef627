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


def _scaled_spd(B, m, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    S = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    d = np.sqrt(np.einsum("bii->bi", S))
    return torch.from_numpy(
        (S / (d[:, :, None] * d[:, None, :])).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("B,m", [(4096, 8), (4096, 14), (4095, 14),
                                 (512, 48), (7, 1), (3, 33)])
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
