"""Tests of the port that need a CUDA card: its kernels (the Gauss-Jordan
inverse, the step perturbation's draw and apply) against their plain
PyTorch versions.  They skip without a card.

This file imports no JAX, so it also runs on a machine without it::

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from lcqpow_tpu_torch import prng
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
# matrices per warp (floor(32/m), m <= 32) nor the warps per block, plus
# the solver's shapes, the circle-N20-512 path's order 42 (its fleet, a
# quarter of it and one retried lane) and the largest order.
@pytest.mark.gpu
@pytest.mark.parametrize("B,m", [(4096, 8), (4096, 14), (4095, 14),
                                 (512, 48), (7, 1), (3, 33), (512, 42),
                                 (128, 42), (1, 42), (4096, 48)]
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
@pytest.mark.parametrize("m", [2, 5, 8, 14, 31, 32, 33, 40, 42, 47, 48])
def test_gj_kernel_keeps_signed_zeros_on_card(m, negate):
    _card()
    S = _scaled_spd(389, m, seed=m, sparse=True, negate=negate).cuda()
    K = pgj.gj_inverse(S)
    P = pgj.gj_inverse_plain(S)
    torch.cuda.synchronize()
    assert _same_bits(K, P)


# At m > 32 the inverse of a sparse SPD matrix is dense, so the signs of
# the identity's zeros past column 31 (the wide kernel's mask bits 32-47)
# reach the result only through structure: -I, and negative definite
# matrices whose factor keeps 1% of its entries.
@pytest.mark.gpu
@pytest.mark.parametrize("m", [33, 40, 42, 48])
def test_gj_kernel_keeps_signed_zeros_past_column_31_on_card(m):
    _card()
    rng = np.random.default_rng(m)
    A = rng.normal(size=(388, m, m)) * (rng.random(size=(388, m, m)) < 0.01)
    S = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    d = np.sqrt(np.einsum("bii->bi", S))
    S = -(S / (d[:, :, None] * d[:, None, :])).astype(np.float32)
    S[(S == 0) & (rng.random(size=S.shape) < 0.5)] = -0.0
    S = torch.cat([-torch.eye(m)[None], torch.from_numpy(S)]).cuda()
    K = pgj.gj_inverse(S)
    P = pgj.gj_inverse_plain(S)
    torch.cuda.synchronize()
    assert bool(((P[:, :, 32:] == 0) & torch.signbit(P[:, :, 32:])).any())
    assert _same_bits(K, P)


# Base pointers that allow no vector load (4-byte offset into storage).
@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 14, 16, 33, 42, 48])
def test_gj_kernel_on_misaligned_input_on_card(m):
    _card()
    S = _scaled_spd(389, m, seed=m).cuda()
    flat = torch.empty(S.numel() + 1, device="cuda")
    Sm = flat[1:].view_as(S)
    Sm.copy_(S)
    assert Sm.is_contiguous() and Sm.data_ptr() % 8 == 4
    assert _same_bits(pgj.gj_inverse(Sm), pgj.gj_inverse_plain(S))


# Base pointers 8 bytes past a 16-byte boundary: 8-byte loads only, at
# orders whose rows would take 16-byte ones.
@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 44, 48])
def test_gj_kernel_on_8_byte_aligned_input_on_card(m):
    _card()
    S = _scaled_spd(389, m, seed=m).cuda()
    flat = torch.empty(S.numel() + 2, device="cuda")
    Sm = flat[2:].view_as(S)
    Sm.copy_(S)
    assert Sm.is_contiguous() and Sm.data_ptr() % 16 == 8
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


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,dtype", [(4, 202, torch.float64),
                                       (5, 130, torch.float32)])
def test_sweep_graph_from_threads_equals_eager(B, n, dtype):
    # Threads on streams of their own capture a fresh shape at the same
    # moment and replay it from the one cache entry: each result has the
    # bits of its eager sweep.
    import threading

    _card()
    from lcqpow_tpu_torch.ops import chol

    rng = np.random.default_rng(n)
    Ms = []
    for _ in range(4):
        A = rng.normal(size=(B, n, n))
        Ms.append(torch.from_numpy(A @ A.transpose(0, 2, 1) / n
                                   + np.eye(n)).to(dtype).cuda())
    wants = [chol._sweep_eager(M, 32) for M in Ms]
    torch.cuda.synchronize()
    gots = [[] for _ in Ms]
    errors = []
    start = threading.Barrier(len(Ms))

    def work(i):
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                start.wait(30)
                for _ in range(5):
                    gots[i].append(chol.sweep_spd_inverse(Ms[i]))
            stream.synchronize()
        except BaseException as e:      # reported by the main thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(Ms))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for got, want in zip(gots, wants):
        assert len(got) == 5
        for g in got:
            assert torch.equal(g.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.gpu
def test_sharded_solve_on_two_streams_of_one_card():
    # A mesh naming the card twice: two worker threads on two streams, each
    # slice bit for bit the solve of its lanes with the fleet's keys.
    _card()
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch.parallel import (make_mesh, shard_batch,
                                           solve_batch_sharded)
    from lcqpow_tpu_torch.problems import warmup_fleet

    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)
    fleet = warmup_fleet(64)
    mesh = make_mesh(["cuda:0", "cuda:0"])
    got = solve_batch_sharded(fleet, opts, mesh=mesh)
    keys = prng.split(prng.prng_key(opts.seed, "cuda"), 64)
    parts = [lt.solve(d, opts, key=k) for d, k in
             zip(shard_batch(fleet, mesh), shard_batch(keys, mesh))]
    for name in ("x", "y", "ret", "algo_status"):
        want = torch.cat([getattr(p, name) for p in parts])
        a = getattr(got, name)
        assert torch.equal(a, want)
        if a.is_floating_point():
            assert torch.equal(a.view(torch.uint8), want.view(torch.uint8))


def _keys_and_mask(B, seed):
    """Per-lane keys of a fleet (a split, as the solver's) and a mask with
    about a third of the lanes off."""
    keys = prng.split(prng.prng_key(seed), B)
    active = torch.from_numpy(np.random.default_rng(seed).random(B) < 0.66)
    return keys.cuda(), active.cuda()


def _iterate(B, n, dtype, seed):
    """(B, n) values of ``dtype`` on the card with -0, +0, subnormals and
    +-1 at every third element among normal draws."""
    flat = np.random.default_rng(seed).normal(size=B * n).astype(dtype)
    tiny = np.finfo(dtype).smallest_subnormal
    special = np.array([-0.0, 0.0, 3 * tiny, -5 * tiny, 1.0, -1.0], dtype)
    flat[::3] = np.resize(special, flat[::3].shape)
    return torch.from_numpy(flat.reshape(B, n)).cuda()


DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64)}


# The main path's, pas-mixed-1024's and pas-warmup-256's shapes (n = 8),
# the circle's chunk, retries and one instance (n = 202), a ragged batch,
# one lane, every n up to 20 at a prime batch, no element at all, and a
# lane count that is not a multiple of the block; in both types.  The draw
# is integer-only and the product with eps exact, so the one rounding is
# the add's (built with --fmad=false): bitwise, -0 and subnormals included.
@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("B,n", [(4096, 8), (1024, 8), (256, 8), (4095, 8),
                                 (32, 202), (8, 202), (5, 202), (1, 202),
                                 (1, 2), (1, 1), (5, 0), (300, 8)]
                         + [(389, n) for n in range(1, 21)])
def test_perturb_apply_kernel_matches_plain_on_card(B, n, dt):
    _card()
    tdt, ndt = DTYPES[dt]
    keys, go = _keys_and_mask(B, seed=B + n)
    x = _iterate(B, n, ndt, seed=B + n)
    eps = torch.finfo(tdt).eps
    before = prng.launch_count
    k, got = prng.perturb_apply(keys, go, x, eps)
    kp, want = prng.perturb_apply_plain(keys, go, x, eps)
    torch.cuda.synchronize()
    assert prng.launch_count == before + 1
    assert torch.equal(k, kp) and _same_bits(got, want)
    assert k.dtype == torch.int64 and got.dtype == tdt
    assert tuple(got.shape) == (B, n)
    assert _same_bits(got[~go], x[~go])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_perturb_apply_kernel_chains_like_plain_on_card(dt):
    # Twenty passes, each from the keys and iterate the last one left, as
    # the solver carries them, with lanes finishing on the way; once
    # through the solver's per-solve launcher, once checked.
    _card()
    tdt, ndt = DTYPES[dt]
    B, n = 64, 8
    keys, _ = _keys_and_mask(B, seed=3)
    x = _iterate(B, n, ndt, seed=3)
    eps = torch.finfo(tdt).eps
    step = prng.perturbation(keys, x, eps)
    kp, xp = keys.clone(), x.clone()
    kc, xc = keys.clone(), x.clone()
    for p in range(20):
        go = (torch.arange(B, device="cuda") >= 3 * p - 20).contiguous()
        keys, x = step(keys, go, x)
        kc, xc = prng.perturb_apply(kc, go, xc, eps)
        kp, xp = prng.perturb_apply_plain(kp, go, xp, eps)
        assert torch.equal(keys, kp) and _same_bits(x, xp), p
        assert torch.equal(kc, kp) and _same_bits(xc, xp), p


@pytest.mark.gpu
def test_perturb_apply_kernel_rejects_what_it_does_not_take():
    # A CUDA tensor the kernel does not take raises; nothing falls back to
    # the plain version.
    _card()
    keys, go = _keys_and_mask(8, seed=1)
    x = _iterate(8, 4, np.float32, seed=1)
    eps = 1e-7
    before = prng.launch_count
    bad = [(keys.to(torch.int32), go, x), (keys, go.to(torch.int32), x),
           (keys.t().contiguous().t(), go, x), (keys, go[:4], x),
           (keys, go.cpu(), x), (keys, go, x.half()), (keys, go, x[:4]),
           (keys, go, x.t().contiguous().t()), (keys, go, x.cpu()),
           (keys, go, x[:, :, None]), (keys, go, x.to(torch.int64))]
    for i, (k, g, xx) in enumerate(bad):
        with pytest.raises(ValueError):
            prng.perturb_apply(k, g, xx, eps)
            pytest.fail(f"case {i} was taken")
    assert prng.launch_count == before
