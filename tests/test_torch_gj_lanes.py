"""The in-place elimination of the GJ kernels (``csrc/gj_inverse.cu``:
``gj_warp_kernel`` for m <= 32, ``gj_wide_kernel`` for m = 33-48),
replayed in PyTorch on the CPU against the plain Gauss-Jordan version, bit
for bit.

The kernels keep m values per row instead of the 2m of ``[M | I]`` and
track only the signs of the identity's not yet pivoted zeros.  That is an
argument about IEEE arithmetic that the card's tests can only sample; here
each step of the kernel (``_lanes``: one row per lane; ``_wide_lanes``: two
row slots per lane with 64-bit sign masks; the same operations in the same
order) is checked on inputs with exact zeros, -0 entries and negative
pivots, where those signs reach the result.
"""

import numpy as np
import pytest
import torch

from lcqpow_tpu_torch.ops.gj_inverse import gj_inverse_plain

ALL = (1 << 32) - 1
#: Every bit of an int64: the wide kernel's 64-bit masks.
ALL64 = -1


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


def _wide_lanes(S, all_bits=ALL64):
    """The wide kernel's arithmetic, 32 < m <= 64: lane i holds row i in
    slot a and row 32 + i in slot b (a zero row where 32 + i >= m), so the
    slots in slot-major order are the rows 0 .. 63 and row k, the pivot of
    step k, is slot k // 32 of lane k % 32.  Rows are stored rotated:
    position p holds column (k + p) mod m at step k, so the pivot column is
    position 0, each step's result moves down one position and the masks
    shift right by one (a logical shift of 64 bits; ``all_bits=ALL`` keeps
    only the low 32, as a 32-bit mask would)."""
    B, m, _ = S.shape
    assert 32 < m <= 64
    a = torch.zeros((B, 64, m), dtype=S.dtype)
    a[:, :m] = S
    neg = torch.zeros((B, 64), dtype=torch.int64)
    slots = torch.arange(64)
    for k in range(m):
        piv = (slots == k)[None, :]
        f = a[:, :, 0].clone()
        r = torch.reciprocal(a[:, k, 0])[:, None]  # every lane, same bits
        t = a[:, k, 1:] * r  # positions 1 .. m-1 of the shuffled pivot row
        new = torch.empty_like(a)
        new[:, :, :-1] = torch.where(
            piv[:, :, None], t[:, None, :],
            a[:, :, 1:] - f[:, :, None] * t[:, None, :])
        nk = neg[:, k:k + 1]
        sr = torch.signbit(r).long() * all_bits
        sf = torch.signbit(f).long() * all_bits
        zk = torch.where((neg & 1).bool(), -0.0, 0.0)
        new[:, :, -1] = torch.where(piv, r, zk - f * r)
        neg = torch.where(piv, nk ^ sr, neg & ~(nk ^ sr ^ sf)) & all_bits
        neg = (neg >> 1) & ((1 << 63) - 1)
        a = new
    # m steps of one position each: position p is column p again.
    return a[:, :m]


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
@pytest.mark.parametrize("m", [1, 2, 5, 8, 14, 32, 33, 40, 42, 47, 48])
def test_lane_elimination_is_plain_gj_bit_for_bit(m, kind):
    S = _batch(64, m, seed=m, kind=kind)
    lanes = _lanes(S) if m <= 32 else _wide_lanes(S)
    assert torch.equal(_bits(lanes), _bits(gj_inverse_plain(S)))


def test_signed_zeros_reach_the_result():
    # Without the sign bits the values still compare equal but the bits do
    # not: the inputs above do exercise the tracking.
    S = _batch(64, 8, seed=8, kind="negative_sparse")
    P = gj_inverse_plain(S)
    assert bool(((P == 0) & torch.signbit(P)).any())
    L = _lanes(S, track_signs=False)
    assert torch.equal(L, P)
    assert not torch.equal(_bits(L), _bits(P))


def _past_column_31(B, m, seed):
    """-I, then negative definite matrices whose factor keeps 1% of its
    entries: rows so loosely coupled that the -0 a negative pivot leaves in
    row i at column j >= i + 32 (bit j - i of the rotated mask) can reach
    the result."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B - 1, m, m)) * (rng.random(size=(B - 1, m, m))
                                          < 0.01)
    S = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    d = np.sqrt(np.einsum("bii->bi", S))
    S = -(S / (d[:, :, None] * d[:, None, :])).astype(np.float32)
    S[(S == 0) & (rng.random(size=S.shape) < 0.5)] = -0.0
    return torch.cat([-torch.eye(m)[None], torch.from_numpy(S)])


@pytest.mark.parametrize("m", [40, 48])
def test_signed_zeros_past_column_31_reach_the_result(m):
    # The wide kernel's masks hold the signs of up to m - 1 columns ahead
    # of the pivot: 64 bits give the plain version's bits; 32 bits give its
    # values with other signs, in columns past 31 only.
    S = _past_column_31(64, m, seed=1)
    P = gj_inverse_plain(S)
    assert bool(((P[:, :, 32:] == 0) & torch.signbit(P[:, :, 32:])).any())
    assert torch.equal(_bits(_wide_lanes(S)), _bits(P))
    L = _wide_lanes(S, all_bits=ALL)
    assert torch.equal(L, P)
    wrong = _bits(L) != _bits(P)
    assert bool(wrong.any()) and not bool(wrong[:, :, :32].any())
