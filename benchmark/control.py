"""The controls of the check that decides ``correct``, and the readings
its limits are set from.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --program-seeds 1,2,...,12 [--calls 2]

At the cell's own width, one process: for each of ``--program-seeds`` the
program as the window drives it, and for each of ``--seeds`` each
control, ``--calls`` calls each; one JSON line of readings per run on
standard output (:func:`reference.combine`'s numbers and the verdict
against the cell's limits).  The controls are the program's own path in
the precision below the one the configuration states:

* ``f32_predictor``: the f32 predictor's own answer and its own
  convergence flag, as the certificate of each lane, in place of the df32
  corrector and certificate (the step that would tempt a later change:
  certify in float32);
* ``no_corrector``: the df32 certificate of the f32 predictor's point,
  with no corrector pass.

Each has to come out not correct: the first fails the stated tolerances,
the second the share of lanes left uncertified.  The benchmark's own runs
do not run this.

With ``--gaps`` each program run also measures how far the float64
residual that the reference takes lies from the certificate's double-word
f32 one (:func:`certificate_gaps`), the rounding that
``reference.DF32_ROUNDING`` has to cover.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --flips

``--flips`` measures instead how many lanes change certification when
only the order or the precision of the sums of the program's batched
matvec changes (:data:`MATVECS`): for each seed, over the fleets of a
run's judged calls (``harness.judged_calls``), the program and then each
variant, with ``ops.linalg``'s ``mv`` and ``mtv`` swapped at run time in
every module of the program that binds them (:data:`MATVEC_USERS`) and
put back afterwards.  One JSON line a seed and side: the lanes left
uncertified, the lanes certified by one side only, each way, and the
reference's verdict.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "benchmark"

from . import harness, reference  # noqa: E402
from .fleet import Fleet  # noqa: E402


def variants(program: harness.Program) -> dict:
    """name -> ``solve(g, x0=None)`` of the program and of each control."""
    lt = program.lt
    from lcqpow_tpu_torch.mixed import _predictor_options

    data = program.data
    m_rows = data.nC + 2 * data.nComp + data.nV
    pred_options = _predictor_options(program.options, m_rows)
    data32 = data.map(lambda a: a.to(torch.float32))
    no_corr = dict(program.kwargs, n_corrector_iters=0)

    def f32_predictor(g, x0=None):
        d = dataclasses.replace(data32, g=g.to(torch.float32))
        return lt.solve_batch(d, pred_options, x0=None if x0 is None
                              else x0.to(torch.float32))

    def no_corrector(g, x0=None):
        d = dataclasses.replace(data, g=g)
        return getattr(lt, program.entry)(d, program.options, x0=x0,
                                          **no_corr)

    return {"program": program, "f32_predictor": f32_predictor,
            "no_corrector": no_corrector}


def certificate_gaps(program: harness.Program, g: torch.Tensor, sol,
                     stat_tol: float) -> dict:
    """The certificate's stationarity residual of every certified lane
    worked out again as the certificate works it out (``mixed.py``'s
    ``stat_phi``: double-word f32, untransformed duals, the penalty term
    ``rho C x``) with the program's own ``ops.df32``, beside the float64
    residual that the reference takes (transformed duals, no penalty
    term).  The untransformed duals are the returned ones plus ``rho Rx``
    and ``rho Lx`` in double-word f32.  Returns the worst gap between the
    two, row by row, in units of ``2^-48`` of the lane's largest sum of
    absolute terms (the unit of ``reference.DF32_ROUNDING``) and of the
    tolerance, how large the penalty's terms grow against that sum, and
    the replayed certificate's worst ratio to the tolerance (under 1 where
    the replay is the certificate's)."""
    from lcqpow_tpu_torch.ops import df32

    data = dataclasses.replace(program.data, g=g)
    if bool((data.g_phi != 0).any()):
        raise ValueError("the replay assumes g_phi = 0 (lbL = lbR = 0)")
    B, n = g.shape
    nC, nK = data.nC, data.nComp
    m0 = nC + 2 * nK
    box = program.options.uses_box_duals
    idx = torch.nonzero(sol.ret == 0).flatten()
    out = dict(gap_u2=0.0, gap_tol=0.0, rho_term_share=0.0, rho_max=0.0,
               replay_ratio=0.0, lanes_replayed=int(idx.numel()))
    for lo in range(0, idx.numel(), reference.BLOCK):
        i = idx[lo:lo + reference.BLOCK]
        k = i.numel()
        x64, y64 = sol.x[i], sol.y[i]
        yc = y64[:, n:] if box else y64
        ybox = y64[:, :n] if box else torch.zeros_like(x64)
        Af = data.A_full[i]
        Q, C, g64 = data.Q[i], data.C[i], g[i]
        rho = sol.stats.rho_opt[i].to(torch.float32)
        eye = torch.eye(n, dtype=Af.dtype, device=Af.device).expand(k, n, n)
        Ahi, Alo = df32.split_mat(torch.cat([Af, eye], -2))
        Qhi, Qlo = df32.split_mat(Q)
        Chi, Clo = df32.split_mat(C)
        x = df32.from_f64(x64)
        yt = df32.from_f64(torch.cat([yc, ybox], -1))
        Ax = df32.split_matvec(Ahi, Alo, x)

        def seg(a, s, e):
            return df32.DF(a.hi[:, s:e], a.lo[:, s:e])

        yL = df32.add(seg(yt, nC, nC + nK),
                      df32.mul_f32(seg(Ax, nC + nK, m0), rho[:, None]))
        yR = df32.add(seg(yt, nC + nK, m0),
                      df32.mul_f32(seg(Ax, nC, nC + nK), rho[:, None]))
        yu = df32.DF(*(torch.cat([a[:, :nC], bl, br, a[:, m0:]], -1)
                       for a, bl, br in ((yt.hi, yL.hi, yR.hi),
                                         (yt.lo, yL.lo, yR.lo))))
        statk = df32.add(
            df32.sub(df32.add(df32.split_matvec(Qhi, Qlo, x),
                              df32.mul_f32(df32.split_matvec(Chi, Clo, x),
                                           rho[:, None])),
                     df32.split_matvec_t(Ahi, Alo, yu)),
            df32.from_f64(g64))
        r_cert = df32.to_f64(statk)
        r_ref = (Q @ x64[:, :, None])[..., 0] + g64 \
            - (Af.mT @ yc[:, :, None])[..., 0] - ybox
        mag = (Q.abs() @ x64.abs()[:, :, None])[..., 0] + g64.abs() \
            + (Af.abs().mT @ yc.abs()[:, :, None])[..., 0] + ybox.abs()
        Lx, Rx = (Af[:, nC:nC + nK] @ x64[:, :, None])[..., 0], \
            (Af[:, nC + nK:] @ x64[:, :, None])[..., 0]
        rho_term = rho.double()[:, None] * (
            (Af[:, nC:nC + nK].abs().mT @ Rx.abs()[:, :, None])[..., 0]
            + (Af[:, nC + nK:].abs().mT @ Lx.abs()[:, :, None])[..., 0])
        gap = (r_ref - r_cert).abs().amax(-1)
        top = mag.amax(-1)
        out["gap_u2"] = max(out["gap_u2"],
                            float((gap / (top * 2.0 ** -48)).amax()))
        out["gap_tol"] = max(out["gap_tol"], float(gap.amax()) / stat_tol)
        out["rho_term_share"] = max(out["rho_term_share"],
                                    float((rho_term.amax(-1) / top).amax()))
        out["rho_max"] = max(out["rho_max"], float(rho.amax()))
        out["replay_ratio"] = max(out["replay_ratio"], float(
            df32.max_abs(statk, axis=-1).amax()) / stat_tol)
    return out


# ---- the flip control --------------------------------------------------------
#: Modules of the program that bind ``ops.linalg.mv`` and ``mtv`` by name.
MATVEC_USERS = ("lcqpow_tpu_torch.ops.linalg", "lcqpow_tpu_torch.ops.df32",
                "lcqpow_tpu_torch.solver", "lcqpow_tpu_torch.mixed",
                "lcqpow_tpu_torch.solvers.admm",
                "lcqpow_tpu_torch.solvers.pas")


def _mv_reordered(A, x):
    """``A @ x``: products rounded to the operands' type, summed over k
    in reversed order by ``torch.sum`` (cuBLAS gemv fuses each product
    into its sum, in an order of its own)."""
    return (A * x.unsqueeze(-2)).flip(-1).sum(-1)


def _mtv_reordered(A, y):
    """``A' @ y`` as :func:`_mv_reordered`."""
    return (A * y.unsqueeze(-1)).flip(-2).sum(-2)


def _mv_f64acc(A, x):
    """``A @ x``: products and sums in float64, rounded once to the
    operands' type."""
    return (A.double() @ x.double().unsqueeze(-1)).squeeze(-1).to(A.dtype)


def _mtv_f64acc(A, y):
    """``A' @ y`` as :func:`_mv_f64acc`."""
    return (y.double().unsqueeze(-2) @ A.double()).squeeze(-2).to(A.dtype)


#: name -> (mv, mtv) of each variant of the matvec.
MATVECS = {"mv_reordered": (_mv_reordered, _mtv_reordered),
           "mv_f64acc": (_mv_f64acc, _mtv_f64acc)}


@contextlib.contextmanager
def matvec_swapped(mv, mtv):
    """``mv`` and ``mtv`` in place of the program's in every module of
    :data:`MATVEC_USERS` that binds them, the program's put back on
    exit."""
    undo = []
    try:
        for name in MATVEC_USERS:
            mod = importlib.import_module(name)
            for attr, fn in (("mv", mv), ("mtv", mtv)):
                if attr in vars(mod):
                    undo.append((mod, attr, getattr(mod, attr)))
                    setattr(mod, attr, fn)
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def flips(cell: harness.Cell, seed: int, device) -> list[dict]:
    """The program's outcome on the fleets of a run's judged calls at
    ``seed``, and each variant of :data:`MATVECS` against it lane by
    lane; each side judged by the reference as a run judges it."""
    fleet = Fleet(cell.config["problem"], cell.traffic["lanes_per_call"],
                  seed, device)
    program = harness.Program(cell.config["solver"], fleet)
    guarantees = cell.config["guarantees"]
    limits = harness.limits(cell.config)
    calls = range(1, harness.judged_calls(cell.traffic) + 1)

    def side(name):
        t0 = time.perf_counter()
        certified, readings, digest = [], [], hashlib.sha256()
        for call in calls:
            inputs = fleet.draw(call)
            sol = program(**inputs)
            certified.append(sol.ret == 0)
            digest.update(sol.ret.cpu().numpy().tobytes())
            readings.append(reference.check_call(fleet, inputs["g"], sol.x,
                                                 sol.y, sol.ret, guarantees))
        numbers = reference.combine(readings)
        numbers.update(
            variant=name, seed=seed, calls=len(calls),
            uncertified=numbers["lanes"] - numbers["certified"],
            ret_sha256=digest.hexdigest()[:16],
            seconds=time.perf_counter() - t0,
            correct=all(numbers[k] <= v for k, v in limits.items()))
        return numbers, certified

    base, base_cert = side("program")
    out = [base]
    for name, (mv, mtv) in MATVECS.items():
        with matvec_swapped(mv, mtv):
            got, cert = side(name)
        got.update(
            uncertified_program=base["uncertified"],
            certified_by_program_only=sum(int((b & ~c).sum())
                                          for b, c in zip(base_cert, cert)),
            certified_by_variant_only=sum(int((c & ~b).sum())
                                          for b, c in zip(base_cert, cert)))
        out.append(got)
    return out


def read(cell: harness.Cell, seed: int, name: str, calls: int,
         device, gaps: bool = False) -> dict:
    """Readings of ``calls`` calls of variant ``name`` on the fleet of
    ``seed`` at the cell's width, judged as a run judges them."""
    fleet = Fleet(cell.config["problem"], cell.traffic["lanes_per_call"],
                  seed, device)
    program = harness.Program(cell.config["solver"], fleet)
    solve = variants(program)[name]
    stat_tol = float(cell.config["guarantees"]["stationarity_tolerance"])
    out, replays = [], []
    t0 = time.perf_counter()
    for call in range(1, calls + 1):
        inputs = fleet.draw(call)
        sol = solve(**inputs)
        out.append(reference.check_call(fleet, inputs["g"], sol.x, sol.y,
                                        sol.ret, cell.config["guarantees"]))
        if gaps and name == "program":
            replays.append(certificate_gaps(program, inputs["g"], sol,
                                            stat_tol))
    numbers = reference.combine(out)
    for k in ("gap_u2", "gap_tol", "rho_term_share", "rho_max",
              "replay_ratio"):
        if replays:
            numbers[k] = max(r[k] for r in replays)
    limits = harness.limits(cell.config)
    numbers.update(variant=name, seed=seed, calls=calls,
                   seconds=time.perf_counter() - t0,
                   correct=all(numbers[k] <= v for k, v in limits.items()))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--gaps", action="store_true")
    ap.add_argument("--flips", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cell = harness.load_cell(root / "BENCHMARK.json", args.workload)
    if args.flips:
        for s in args.seeds.split(","):
            for line in flips(cell, int(s), args.device):
                print(json.dumps(line), flush=True)
        return 0
    runs = [("program", int(s)) for s in args.program_seeds.split(",") if s]
    runs += [(v, int(s)) for s in args.seeds.split(",") if s
             for v in ("f32_predictor", "no_corrector")]
    for name, seed in runs:
        print(json.dumps(read(cell, seed, name, args.calls, args.device,
                              args.gaps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
