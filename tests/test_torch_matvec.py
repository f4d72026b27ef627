"""The batched matvec of ``ops.linalg`` (``mv``, ``mtv``): the CPU path is
``torch.matmul`` bit for bit, the dispatch rule sends each input to the
kernel or to ``torch.matmul`` by what it can see, the counters count only
their own calls; on the card, the kernel of ``csrc/matvec.cu`` gives
``torch.matmul``'s bits at every shape it takes, and a whole solve of each
benchmark configuration is the same with it and without it.

This file imports no JAX; its card tests run with::

    python -m pytest --noconftest tests/test_torch_matvec.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from lcqpow_tpu_torch.ops import linalg

# The (m, n, transposed) the solver drives in the benchmark's cells.
SHAPES = [(2, 8, False), (8, 8, False), (14, 8, False), (14, 8, True),
          (14, 14, False)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _operands(B, m, n, trans, seed, device="cpu", dtype=torch.float32):
    """A (B, m, n) and the vector of ``mv`` (or ``mtv``): signs, mantissas
    and exponents 2^-10 .. 2^10 at random, 1/16 of them +0 or -0."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        v = (rng.choice([-1.0, 1.0], size=shape) * (1 + rng.random(shape))
             * np.exp2(rng.integers(-10, 11, size=shape)))
        zero = rng.random(shape) < 1 / 16
        v[zero] = np.copysign(0.0, v[zero])
        return torch.from_numpy(v).to(dtype=dtype, device=device)
    return draw((B, m, n)), draw((B, m if trans else n))


def _call(A, v, trans):
    return linalg.mtv(A, v) if trans else linalg.mv(A, v)


def _plain(A, v, trans):
    return linalg.mtv_plain(A, v) if trans else linalg.mv_plain(A, v)


def _same_bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


# ---- CPU ---------------------------------------------------------------------
@pytest.mark.parametrize("m,n,trans", SHAPES + [(42, 42, False),
                                                (103, 103, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_path_is_matmul_bit_for_bit(m, n, trans, dtype):
    A, v = _operands(37, m, n, trans, seed=m + n, dtype=dtype)
    calls, launches = linalg.matvec_call_count, linalg.matvec_launch_count
    got = _call(A, v, trans)
    want = ((v.unsqueeze(-2) @ A).squeeze(-2) if trans
            else (A @ v.unsqueeze(-1)).squeeze(-1))
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # A CPU call is neither a CUDA call nor a launch.
    assert linalg.matvec_call_count == calls
    assert linalg.matvec_launch_count == launches


def test_dispatch_rule_sends_each_input_to_its_side():
    f32 = torch.float32

    def takes(A, v, trans=False):
        return linalg.kernel_takes(A, v, trans)
    for m, n, trans in SHAPES:
        A, v = _operands(5, m, n, trans, seed=1)
        assert takes(A, v, trans)
        # float64 (pas-warmup-256's f64 homotopy) stays on torch.matmul.
        assert not takes(A.double(), v.double(), trans)
        # Strided lanes, rows and vectors: the tiled kernel takes the
        # strides; the one-thread-a-lane kernel of (2, 8) takes packed
        # operands only.
        big = torch.zeros(5, m, n + 3)
        big[:, :, :n] = A
        vv = torch.zeros(5, 2 * v.shape[1])
        vv[:, ::2] = v
        assert takes(big[:, :, :n], vv[:, ::2], trans) == ((m, n) != (2, 8))
        assert takes(big[:, :, :n], v, trans) == ((m, n) != (2, 8))
        assert takes(A, vv[:, ::2], trans) == ((m, n) != (2, 8))
        # A per-lane column-major matrix (last stride not 1) does not go.
        assert not takes(A.mT.contiguous().mT, v, trans)
    # Packed (2, 8) operands off a 16-byte boundary do not go either.
    A, v = _operands(5, 2, 8, False, seed=9)
    flat, flat_v = torch.zeros(5 * 16 + 1), torch.zeros(5 * 8 + 1)
    A1 = flat[1:].view(5, 2, 8)
    v1 = flat_v[1:].view(5, 8)
    assert A1.stride() == A.stride() and v1.stride() == v.stride()
    assert takes(A, v) and takes(flat[:80].view(5, 2, 8), v)
    assert not takes(A1, v) and not takes(A, v1)
    A, v = _operands(5, 14, 8, False, seed=2)
    # The other direction at a shape the kernel takes one way only.
    assert not takes(*_operands(5, 8, 8, True, seed=8), True)
    # The circle fleets' orders, a shared 2-D matrix, an order the cells
    # do not drive, an empty batch, mismatched operands.
    assert not takes(*_operands(3, 42, 42, False, seed=3))
    assert not takes(*_operands(3, 103, 103, False, seed=4))
    assert not takes(A[0], v)
    assert not takes(*_operands(3, 8, 14, False, seed=5))
    assert not takes(torch.zeros(0, 14, 8, dtype=f32),
                     torch.zeros(0, 8, dtype=f32))
    assert not takes(A, v[:4])
    assert not takes(A, torch.zeros(5, 14))
    assert not takes(A, v.double())


def test_counters_count_only_their_own_calls(monkeypatch):
    launched = []

    def fake_launch(A, v, out, trans):
        launched.append(tuple(A.shape))
        out.copy_(_plain(A, v, trans))
    monkeypatch.setattr(linalg, "_launch", fake_launch)
    calls, launches = linalg.matvec_call_count, linalg.matvec_launch_count
    A, v = _operands(6, 14, 8, True, seed=6)
    assert torch.equal(linalg._on_card(A, v, True), _plain(A, v, True))
    A2, v2 = _operands(6, 14, 8, False, seed=7, dtype=torch.float64)
    assert torch.equal(linalg._on_card(A2, v2, False),
                       _plain(A2, v2, False))
    assert launched == [(6, 14, 8)]
    assert linalg.matvec_call_count == calls + 2
    assert linalg.matvec_launch_count == launches + 1
    # The launch is recorded by its shape too, the plain call is not.
    assert linalg.matvec_launch_shapes[6, 14, 8, True] >= 1
    assert (6, 14, 8, False) not in linalg.matvec_launch_shapes


def test_launch_orders_follow_cublas_launches():
    L = linalg.CUBLAS_LAUNCH
    # Every table starts at one lane and rises.
    for table in linalg.MATVEC_ORDERS.values():
        firsts = [f for f, _ in table]
        assert firsts[0] == 1 and firsts == sorted(set(firsts))
    # The cells' width: four full launches and a remainder of four lanes.
    assert 262144 == 4 * L + 4
    assert linalg.launch_orders(8, 8, False, 262144) == (
        linalg.HALVES, linalg.HALVES, 4 * L)
    assert linalg.launch_orders(14, 8, True, 262144) == (
        linalg.HALVES, linalg.QUADS_0213, 4 * L)
    assert linalg.launch_orders(14, 14, False, 262144) == (
        linalg.MOD4, linalg.HALVES, 4 * L)
    # One launch: every lane is in the remainder.
    assert linalg.launch_orders(14, 14, False, 4096) == (
        linalg.HALVES, linalg.HALVES, 0)
    assert linalg.launch_orders(2, 8, False, 20000)[1] == linalg.EVEN_ODD
    assert linalg.launch_orders(14, 8, True, 128)[1] == linalg.PAIRS8
    assert linalg.launch_orders(14, 8, True, 1000)[1] == linalg.QUADS_SEQ
    assert linalg.launch_orders(14, 8, True, 2 * L)[2] == 2 * L


# ---- card --------------------------------------------------------------------
# Launch sizes at which cuBLAS changes kernels (MATVEC_ORDERS), both sides of
# each change, and the cells' width.
EDGES = {
    False: [1, 2, 64, 12997, 12998, 37292, 37293, 65535, 65536,
            2 * 65535 + 12998, 262144],
    True: [1, 2, 126, 127, 129, 130, 149, 150, 189, 190, 791, 792, 1335,
           1336, 2852, 2853, 65535, 65537, 65535 + 128, 65535 + 1000,
           262144],
}


def _layouts(A, v, kind):
    """``A`` and ``v`` as the kernel receives them: contiguous, or each a
    strided view (padded lanes and rows of A, every other element of v)."""
    if kind == "contiguous":
        return A, v
    B, m, n = A.shape
    big = torch.zeros(B, m + 1, n + 3, device=A.device)
    big[:, :m, :n] = A
    vv = torch.zeros(B, 2 * v.shape[1] + 1, device=v.device)
    vv[:, 1::2] = v
    return big[:, :m, :n], vv[:, 1::2]


def _probe(B, m, n, trans, pair, device):
    """Ones, with +2^30 and -2^30 at terms ``pair`` of every sum: the result
    counts the ones added after the two cancel, which shows the grouping."""
    K = m if trans else n
    A = torch.ones(B, m, n, device=device)
    i, j = pair
    if trans:
        A[:, i, :], A[:, j, :] = 2.0 ** 30, -(2.0 ** 30)
    else:
        A[:, :, i], A[:, :, j] = 2.0 ** 30, -(2.0 ** 30)
    return A, torch.ones(B, K, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["contiguous", "strided"])
@pytest.mark.parametrize("B", [1, 4095, 4096, 262144])
@pytest.mark.parametrize("m,n,trans", SHAPES)
def test_kernel_gives_matmul_bits_on_card(m, n, trans, B, kind):
    _card()
    A, v = _operands(B, m, n, trans, seed=B + m + n, device="cuda")
    A, v = _layouts(A, v, kind)
    before = linalg.matvec_launch_count
    got = _call(A, v, trans)
    want = _plain(A, v, trans)
    torch.cuda.synchronize()
    # (2, 8) strided operands go to torch.matmul: only packed ones launch.
    launched = kind == "contiguous" or (m, n) != (2, 8)
    assert linalg.matvec_launch_count == before + launched
    assert _same_bits(got, want)
    K = m if trans else n
    for pair in [(0, 1), (0, K - 1), (1, K // 2), (K // 2 - 1, K // 2),
                 (2, K - 2), (3, 7)]:
        P, ones = _layouts(*_probe(B, m, n, trans, pair, "cuda"), kind)
        assert _same_bits(_call(P, ones, trans), _plain(P, ones, trans))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,trans", SHAPES)
def test_kernel_gives_matmul_bits_at_every_launch_size_edge_on_card(
        m, n, trans):
    _card()
    for B in EDGES[trans]:
        A, v = _operands(B, m, n, trans, seed=B, device="cuda")
        assert _same_bits(_call(A, v, trans), _plain(A, v, trans)), B


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["admm", "pas"])
def test_solve_is_the_same_with_the_kernel_and_with_matmul_on_card(
        engine, monkeypatch):
    # One benchmark-width call of each configuration (warmup-admm,
    # warmup-pas): x, the multipliers and ret bit for bit.
    _card()
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch.problems import warmup_fleet

    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200,
                      inner_solver=engine)
    data = warmup_fleet(262144, device="cuda")

    def solve():
        return lt.solve_batch_mixed(data, opts, n_corrector_iters=6,
                                    escalate=0)
    before = linalg.matvec_launch_count
    got = solve()
    assert linalg.matvec_launch_count > before
    monkeypatch.setattr(linalg, "kernel_takes", lambda *a: False)
    launches = linalg.matvec_launch_count
    want = solve()
    assert linalg.matvec_launch_count == launches
    for name in ("x", "y", "ret"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
