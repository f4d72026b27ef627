"""The port's utility, ingestion and reporting layers, held to the JAX
package on the CPU: the reference-named dense kernels of ``ops/linalg.py``,
CSC conversion (``ops/csc.py``), the reference text format
(``io.py``) and the object API's file and sparse loads, the messages and
banners (``messages.py``), and the INNER and OUTER iteration tables of an
unbatched ``solve``.

Tolerances: the dense kernels to 1e-14 (the same f64 products, summed in
another order); CSC arrays, file contents, messages and banners are equal;
the
solves run with ``perturb_step=False`` and agree to 1e-9 in x; the printed
tables have equal headers, row counts and integer columns, and float
columns equal to relative 1e-3 (the precision of ``%10.3e``) above an
absolute 1e-10, below which an entry is rounding (a stationarity of 4.4e-16
in one package, 2.2e-16 in the other); see
``test_iteration_table_matches_jax`` for the columns held on the warm-up.
"""

import os

import numpy as np
import pytest

import lcqpow_tpu as jl
from lcqpow_tpu import io as jio
from lcqpow_tpu.ops import csc as jcsc
from lcqpow_tpu.problems import warm_up as j_warm_up

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import io as pio
from lcqpow_tpu_torch.ops import csc as pcsc
from lcqpow_tpu_torch.problems import warm_up as p_warm_up

WARM_UP = dict(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
               L=[[1., 0.]], R=[[0., 1.]])


# ------------------------------------------------------- dense kernels
LINALG = {
    "matrix_multiplication": lambda m, A, B, v, w, a, b: m(A, v),
    "matrix_multiplication_matrix": lambda m, A, B, v, w, a, b: m(A, B),
    "transposed_matrix_multiplication": lambda m, A, B, v, w, a, b: m(A, w),
    "matrix_symmetrization_product": lambda m, A, B, v, w, a, b: m(A, B),
    "affine_linear_transformation":
        lambda m, A, B, v, w, a, b: m(a, A, v, w),
    "weighted_matrix_add": lambda m, A, B, v, w, a, b: m(a, A, b, B),
    "weighted_vector_add": lambda m, A, B, v, w, a, b: m(a, v, b, w),
    "quadratic_form_product": lambda m, A, B, v, w, a, b: m(A, v),
    "dot_product": lambda m, A, B, v, w, a, b: m(v, w),
    "max_abs": lambda m, A, B, v, w, a, b: m(v),
}


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg_matches_jax(name):
    import jax
    import jax.numpy as jnp
    import torch

    from lcqpow_tpu.ops import linalg as jla
    from lcqpow_tpu_torch.ops import linalg as pla

    rng = np.random.default_rng(7)
    A = rng.normal(size=(3, 5, 5))
    B = rng.normal(size=(3, 5, 5))
    v = rng.normal(size=(3, 5))
    w = rng.normal(size=(3, 5))
    a, b = 0.75, -1.25
    fname = name.removesuffix("_matrix")
    call = LINALG[name]
    # Batched: the port broadcasts over the lane axis, JAX vmaps.
    t = [torch.from_numpy(z) for z in (A, B, v, w)]
    got = call(getattr(pla, fname), *t, a, b).numpy()
    want = jax.vmap(lambda *z: call(getattr(jla, fname), *z, a, b))(
        *(jnp.asarray(z) for z in (A, B, v, w)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-14)
    # One instance.
    one = call(getattr(pla, fname), *(z[0] for z in t), a, b).numpy()
    np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-14)


def test_max_abs_is_the_infinity_norm():
    import torch

    from lcqpow_tpu_torch.ops.linalg import max_abs

    assert float(max_abs(torch.tensor([1.0, -3.0, 2.0]))) == 3.0


def _csc_fields(M):
    return (M.m, M.n, M.indptr.tolist(), M.indices.tolist(), M.data.tolist())


# ---------------------------------------------------------------- CSC layer
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csc_roundtrip_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        m, n = (int(v) for v in rng.integers(1, 12, size=2))
        A = rng.normal(size=(m, n))
        A[rng.random(size=(m, n)) < 0.6] = 0.0      # exact zeros
        P, J = pcsc.dense_to_csc(A), jcsc.dense_to_csc(A)
        assert _csc_fields(P) == _csc_fields(J)
        assert P.nnz == np.count_nonzero(A)
        np.testing.assert_array_equal(pcsc.csc_to_dense(P), A)
        np.testing.assert_array_equal(pcsc.csc_to_dense(P),
                                      jcsc.csc_to_dense(J))


def test_csc_drops_exact_zeros_and_nan():
    A = np.array([[0.0, 1.0], [-2.0, np.nan], [-0.0, 3.0]])
    P, J = pcsc.dense_to_csc(A), jcsc.dense_to_csc(A)
    assert P.nnz == J.nnz == 3
    assert _csc_fields(P) == _csc_fields(J)


def test_csc_short_indptr_stops_at_nnz():
    # Padded index and value arrays: the conversion reads nnz = indptr[n]
    # entries and ignores the rest (src/Utilities.cpp:602-604).
    args = (3, 2, [0, 1, 3], [2, 0, 1, 2, 2], [1.5, -2.0, 4.0, 9.0, 9.0])
    P, J = pcsc.CSCMatrix(*args), jcsc.CSCMatrix(*args)
    assert P.nnz == 3
    np.testing.assert_array_equal(P.toarray(), J.toarray())
    np.testing.assert_array_equal(
        P.toarray(), [[0.0, -2.0], [0.0, 4.0], [1.5, 0.0]])


def test_csc_upper_triangular_matches_jax():
    rng = np.random.default_rng(3)
    S = rng.normal(size=(7, 7))
    S[rng.random(size=S.shape) < 0.4] = 0.0
    S = S + S.T
    P = pcsc.csc_upper_triangular(pcsc.dense_to_csc(S))
    J = jcsc.csc_upper_triangular(jcsc.dense_to_csc(S))
    assert _csc_fields(P) == _csc_fields(J)
    np.testing.assert_array_equal(P.toarray(), np.triu(S))


@pytest.mark.parametrize("args", [
    (2, 2, 1, [1.0], [5], [0, 1, 1]),     # row index out of range
    (2, 2, 1, [1.0], [0], [1, 1, 1]),     # indptr[0] != 0
    (2, 2, 2, [1.0], [0], [0, 1, 1]),     # nnz mismatch
    (2, 2, 1, [1.0], [0], [0, 1]),        # indptr too short
], ids=["row_range", "indptr0", "nnz", "indptr_len"])
def test_create_csc_rejects_like_jax(args):
    with pytest.raises(ValueError) as jerr:
        jcsc.create_csc(*args)
    with pytest.raises(ValueError) as perr:
        pcsc.create_csc(*args)
    assert str(perr.value) == str(jerr.value)


def test_scipy_interop():
    sp = pytest.importorskip("scipy.sparse")
    A = sp.random(6, 5, density=0.4, random_state=4, format="csc")
    P, J = pcsc.CSCMatrix.from_scipy(A), jcsc.CSCMatrix.from_scipy(A)
    assert _csc_fields(P) == _csc_fields(J)
    np.testing.assert_array_equal(P.toarray(), A.toarray())


# ---------------------------------------------------------------- messages
def test_messages_equal_jax():
    for rv in pl_.ReturnValue:
        assert pl_.message(rv) == jl.message(jl.ReturnValue(int(rv))), rv
    for st in pl_.AlgorithmStatus:
        assert pl_.solution_banner(st) \
            == jl.solution_banner(jl.AlgorithmStatus(int(st))), st
    assert "## S-Stationary solution found ##" in pl_.solution_banner(
        pl_.AlgorithmStatus.S_STATIONARY_SOLUTION)


def test_print_message_and_solution_equal_jax(capsys):
    for lt in (jl, pl_):
        assert lt.print_message(lt.ReturnValue.MAX_PENALTY_REACHED) \
            == lt.ReturnValue.MAX_PENALTY_REACHED
        lt.print_solution(lt.AlgorithmStatus.M_STATIONARY_SOLUTION)
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "maximum penalty" in out


# ------------------------------------------------------------ file format
def _write_problem(d, io, fields):
    for k, v in fields.items():
        io.write_vector(os.path.join(d, f"{k}.txt"), np.ravel(v))


def test_vector_roundtrip_across_packages(tmp_path):
    vals = np.array([1.5, -2.25e-13, 3e7, 0.0, -1.0, 1.0 / 3.0, np.pi])
    p, j = str(tmp_path / "p.txt"), str(tmp_path / "j.txt")
    pio.write_vector(p, vals)
    jio.write_vector(j, vals)
    for path in (p, j):
        np.testing.assert_array_equal(pio.read_vector(path), vals)
        np.testing.assert_array_equal(jio.read_vector(path), vals)
    with open(p) as f:
        assert f.read().split() == [f"{v:.17g}" for v in vals]


def test_read_vector_messy_whitespace(tmp_path):
    p = str(tmp_path / "messy.txt")
    with open(p, "w") as f:
        f.write("1.0  2.5\n\t-3e-2\n\n4\n")
    np.testing.assert_array_equal(pio.read_vector(p), jio.read_vector(p))
    np.testing.assert_array_equal(pio.read_vector(p), [1.0, 2.5, -0.03, 4.0])


def test_load_lcqp_from_files_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    nV, nC, nK = 5, 2, 2
    fields = dict(
        Q=np.eye(nV) + 0.1 * np.ones((nV, nV)), g=rng.normal(size=nV),
        L=rng.normal(size=(nK, nV)), R=rng.normal(size=(nK, nV)),
        lbL=[0.0, 0.5], ubL=[1e20, 3.0], lbR=[0.0, -1.0], ubR=[2.0, 1e20],
        A=rng.normal(size=(nC, nV)), lbA=[-1.0, -2.0], ubA=[1.0, 2.0],
        lb=-np.ones(nV), ub=np.ones(nV), x0=rng.normal(size=nV))
    d = str(tmp_path)
    _write_problem(d, pio, fields)
    p = pio.load_lcqp_from_files(d, as_numpy=True)
    j = jio.load_lcqp_from_files(d, as_numpy=True)
    assert (p.nV, p.nC, p.nComp) == (j.nV, j.nC, j.nComp) == (nV, nC, nK)
    for k in p.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(p, k)),
                                      np.asarray(getattr(j, k)), err_msg=k)
    np.testing.assert_array_equal(pio.load_x0_from_files(d),
                                  jio.load_x0_from_files(d))
    t = pio.load_lcqp_from_files(d, device="cpu")
    np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))


def test_compat_file_load_matches_jax(tmp_path):
    d = str(tmp_path)
    data = j_warm_up()
    _write_problem(d, jio, {k: np.asarray(getattr(data, k))
                            for k in ("Q", "g", "L", "R")})
    outs = []
    for lcqp, lt in ((jl.LCQProblem(), jl),
                     (pl_.LCQProblem(device="cpu"), pl_)):
        assert lcqp.load_lcqp_from_files(d) == 0
        assert (lcqp.nV, lcqp.nC, lcqp.nComp) == (2, 0, 1)
        lcqp.set_options(lt.Options(print_level=0, perturb_step=False))
        assert lcqp.run_solver() == 0
        outs.append(lcqp)
    j, p = outs
    np.testing.assert_allclose(p.get_primal_solution(),
                               j.get_primal_solution(), rtol=0, atol=1e-9)
    assert p.get_output_statistics().get_iter_total() \
        == j.get_output_statistics().get_iter_total()


def test_compat_sparse_load_osqp_y0_trim_matches_jax():
    # A scipy CSC load (sparse mode at once), OSQP mode, and a full-length
    # dual guess [box; L; R] whose box block OSQP mode drops.
    sp = pytest.importorskip("scipy.sparse")
    y0 = np.array([9.0, 9.0, 0.1, -0.2])
    outs = []
    for lcqp, lt in ((jl.LCQProblem(2, 0, 1), jl),
                     (pl_.LCQProblem(2, 0, 1, device="cpu"), pl_)):
        lcqp.set_options(lt.Options(print_level=0, perturb_step=False,
                                    qp_solver=lt.QPSolver.OSQP_SPARSE))
        assert lcqp.load_lcqp(
            sp.csc_matrix(WARM_UP["Q"]), WARM_UP["g"],
            sp.csc_matrix(WARM_UP["L"]), sp.csc_matrix(WARM_UP["R"]),
            x0=[1.0, 0.5], y0=y0) == 0
        assert lcqp.run_solver() == 0
        outs.append(lcqp)
    j, p = outs
    assert p.get_dual_solution().shape == (2,)
    np.testing.assert_allclose(p.get_primal_solution(),
                               j.get_primal_solution(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.get_dual_solution(),
                               j.get_dual_solution(), rtol=0, atol=1e-9)


# ------------------------------------------------------- iteration tables
def parse_table(text):
    """(rows, header_before): the table's rows as lists of numbers, and for
    each row whether a header came right before it."""
    rows, header_before, pending = [], [], False
    for line in text.splitlines():
        cells = [c.strip() for c in line.split("|")]
        if cells[0] == "outer":
            pending = True
        elif len(cells) in (5, 8) and cells[0].lstrip("-").isdigit():
            rows.append([int(c) if c.lstrip("-").isdigit() else float(c)
                         for c in cells])
            header_before.append(pending)
            pending = False
    return rows, header_before


def _tables(level, problem, capsys):
    """The parsed table each package prints for one unbatched solve, with
    the solve's pass and outer-iteration counts."""
    import jax

    out = {}
    for lt in (jl, pl_):
        kw = {} if lt is jl else {"device": "cpu"}
        data = lt.make_lcqp(**(WARM_UP | PROBLEMS[problem]), **kw)
        opts = lt.Options(print_level=getattr(lt.PrintLevel, level),
                          perturb_step=False)
        sol = lt.solve(data, opts)
        if lt is jl:
            jax.block_until_ready(sol.x)
            jax.effects_barrier()
        out[lt] = (*parse_table(capsys.readouterr().out),
                   int(sol.stats.iter_total), int(sol.stats.iter_outer))
    return out[jl], out[pl_]


# The warm-up, and the warm-up with its target moved off the diagonal
# (g = (-2, -3): solution (0, 1.5), 39 passes).
PROBLEMS = {"warm_up": {}, "warm_up_g23": {"g": [-2.0, -3.0]}}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("level", ["INNER_LOOP_ITERATES",
                                   "OUTER_LOOP_ITERATES"])
def test_iteration_table_matches_jax(level, problem, capsys):
    (jrows, jhead, jtotal, jouter), (prows, phead, ptotal, pouter) = \
        _tables(level, problem, capsys)
    assert (ptotal, pouter) == (jtotal, jouter)
    assert phead == jhead and len(prows) == len(jrows)
    if level == "INNER_LOOP_ITERATES":
        assert len(prows) == ptotal                 # one row per pass
        ints = (0, 1, 7)
        assert phead == [r[1] % 10 == 0 for r in prows]
    else:
        # One row per pass with inner == 0: outer counts up, skipping a
        # pass that fired two penalty updates.
        outers = [r[0] for r in prows]
        assert outers == sorted(set(outers)) and outers[-1] <= pouter
        ints = (0,)
        assert phead == [r[0] % 10 == 0 for r in prows]
    for pr, jr in zip(prows, jrows):
        assert [pr[i] for i in ints] == [jr[i] for i in ints]
    # Float columns: station, complem, rho, norm p (and alpha).  Without
    # perturbation the warm-up runs along its symmetric saddle x1 = x2,
    # where the last passes' steps and duals are set by rounding (norm p
    # 1e-16, station 2.0 in one package and 7e-7 in the other), so there
    # only complem and rho are held; off the diagonal every column is.
    # alpha = -l/q scales a step of rounding size where norm p is below
    # 1e-10, and is held only where it is not.
    cols = (3, 4) if problem == "warm_up" else (2, 3, 4, 5)
    if level == "OUTER_LOOP_ITERATES":
        cols = tuple(c - 1 for c in cols)
    for pr, jr in zip(prows, jrows):
        take = list(cols)
        if level == "INNER_LOOP_ITERATES" and problem != "warm_up" \
                and jr[5] > 1e-10:
            take.append(6)
        np.testing.assert_allclose([pr[i] for i in take],
                                   [jr[i] for i in take], rtol=1e-3,
                                   atol=1e-10, err_msg=str(jr))


def test_batched_solve_prints_nothing(capsys):
    from lcqpow_tpu_torch.problems import warmup_fleet

    opts = pl_.Options(print_level=pl_.PrintLevel.INNER_LOOP_ITERATES)
    pl_.solve(warmup_fleet(2, device="cpu"), opts)
    pl_.solve(pl_.stack_lcqps([p_warm_up(device="cpu")]), opts)
    assert capsys.readouterr().out == ""
    pl_.solve(p_warm_up(device="cpu"), opts)
    assert "station" in capsys.readouterr().out
