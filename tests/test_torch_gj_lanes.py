"""The in-place elimination of the warp kernel (``csrc/gj_inverse.cu``,
``gj_warp_kernel``), replayed in PyTorch on the CPU against the plain
Gauss-Jordan version, bit for bit.

The kernel keeps m values per row instead of the 2m of ``[M | I]`` and
tracks only the signs of the identity's not yet pivoted zeros.  That is an
argument about IEEE arithmetic that the card's tests can only sample; here
each step of the kernel (``_lanes``, one row per lane, the same operations
in the same order) is checked on inputs with exact zeros, -0 entries and
negative pivots, where those signs reach the result.
"""

import numpy as np
import pytest
import torch

from lcqpow_tpu_torch.ops.gj_inverse import gj_inverse_plain

ALL = (1 << 32) - 1


def _lanes(S, track_signs=True):
    """The warp kernel's arithmetic: slot k of row i becomes I[i,k] at step
    k; bit j of ``neg`` is the sign of the zero I[i,j], j not yet pivoted."""
    B, m, _ = S.shape
    a = S.clone()
    neg = torch.zeros((B, m), dtype=torch.int64)
    rows = torch.arange(m)
    for k in range(m):
        piv = (rows == k)[None, :]
        f = a[:, :, k].clone()
        r = torch.reciprocal(a[:, k, k])[:, None]  # every lane, same bits
        t = a[:, k, :] * r  # the shuffled pivot row, times r
        new = torch.where(piv[:, :, None], t[:, None, :],
                          a - f[:, :, None] * t[:, None, :])
        nk = neg[:, k:k + 1]
        sr = torch.signbit(r).long() * ALL
        sf = torch.signbit(f).long() * ALL
        if track_signs:
            zk = torch.where(((neg >> k) & 1).bool(), -0.0, 0.0)
        else:
            zk = torch.zeros_like(f)
        new[:, :, k] = torch.where(piv, r, zk - f * r)
        neg = torch.where(piv, nk ^ sr, neg & ~(nk ^ sr ^ sf) & ALL)
        a = new
    return a


def _batch(B, m, seed, kind):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    if kind != "dense":
        A *= rng.random(size=A.shape) < 0.25
    S = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    d = np.sqrt(np.einsum("bii->bi", S))
    S = (S / (d[:, :, None] * d[:, None, :])).astype(np.float32)
    if kind == "negative_sparse":
        S = -S
    if kind != "dense":
        S[(S == 0) & (rng.random(size=S.shape) < 0.5)] = -0.0
    return torch.from_numpy(S)


def _bits(X):
    return X.view(torch.int32)


@pytest.mark.parametrize("kind", ["dense", "sparse", "negative_sparse"])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 14, 32])
def test_lane_elimination_is_plain_gj_bit_for_bit(m, kind):
    S = _batch(64, m, seed=m, kind=kind)
    assert torch.equal(_bits(_lanes(S)), _bits(gj_inverse_plain(S)))


def test_signed_zeros_reach_the_result():
    # Without the sign bits the values still compare equal but the bits do
    # not: the inputs above do exercise the tracking.
    S = _batch(64, 8, seed=8, kind="negative_sparse")
    P = gj_inverse_plain(S)
    assert bool(((P == 0) & torch.signbit(P)).any())
    L = _lanes(S, track_signs=False)
    assert torch.equal(L, P)
    assert not torch.equal(_bits(L), _bits(P))
