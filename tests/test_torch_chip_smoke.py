"""``chip_smoke.py``'s reading of nvcc's ``-Xptxas -v`` report, on an
excerpt of the report for ``lcqpow_tpu_torch/csrc/gj_inverse.cu``."""

import pytest

import chip_smoke

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115gj_block_kernelILi48EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115gj_block_kernelILi48EEEvPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 48000 bytes smem
ptxas info    : Compile time = 94.783 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114gj_warp_kernelILi14ELi2EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114gj_warp_kernelILi14ELi2EEEvPKfPfi
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 372 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114gj_warp_kernelILi13ELi1EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114gj_warp_kernelILi13ELi1EEEvPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers, 372 bytes cmem[0]
"""


@pytest.mark.parametrize("key,want", [
    (("gj_block_kernel", 48, 0), [127, 0, 0]),
    (("gj_warp_kernel", 14, 2), [48, 4, 12]),
])
def test_ptxas_usage_reads_registers_and_spills(key, want):
    usage = chip_smoke.ptxas_usage(LOG, (14, 48))
    assert usage[key] == want
    assert ("gj_warp_kernel", 13, 1) not in usage


def test_paths_pin_at_least_the_jax_counts():
    # Each path's pinned outcome certifies at least the JAX package's count
    # (its floor) and accounts for every lane of its fleet.
    lanes = {"pas-mixed-1024": 1024, "pas-warmup-256": 256,
             "circle-N100": chip_smoke.CIRCLE_B}
    for name, p in chip_smoke.PATHS.items():
        pinned = p["pinned"]
        assert pinned["certified"] >= p["floor"], name
        by = pinned.get("stages") or pinned["rets"]
        assert sum(by.values()) == lanes[name], name
    # The f64 path never reaches the float32 kernel; the circle's inverses
    # are all sweeps (n > 48).
    assert chip_smoke.PATHS["pas-warmup-256"]["pinned"]["launches_by_m"] == {}
    assert chip_smoke.PATHS["circle-N100"]["pinned"]["launches_by_m"] == {}
    # Only the circle is audited against a ceiling in place of the strict
    # audit, and the ceiling is no looser than its certificate's bound
    # 1e-9 (1 + max|Ax|) at max|Ax| = 2.
    ceilings = {name: p.get("audit_ceiling")
                for name, p in chip_smoke.PATHS.items()}
    assert ceilings == {"pas-mixed-1024": None, "pas-warmup-256": None,
                        "circle-N100": chip_smoke.CIRCLE_AUDIT_CEILING}
    assert chip_smoke.CIRCLE_AUDIT_CEILING <= 3e-9


def test_kernel_shapes_cover_every_driven_shape():
    # The kernel is held bitwise against its plain version at every (B, m)
    # the driven paths launch it at (each of those paths runs at full
    # width: the main path at B_MAIN, pas-mixed-1024 at 1024).
    driven = {(chip_smoke.B_MAIN, m)
              for m in chip_smoke.MAIN_EXPECTED["launches_by_m"]}
    driven |= {(1024, m) for m in
               chip_smoke.PATHS["pas-mixed-1024"]["pinned"]["launches_by_m"]}
    # The api phase's one-call mixed path: one matrix at a time.
    driven |= set(chip_smoke.API_SHAPES)
    assert driven <= set(chip_smoke.KERNEL_SHAPES)
    assert len(set(chip_smoke.KERNEL_SHAPES)) == len(chip_smoke.KERNEL_SHAPES)


def test_path_outcome_and_strict_audit_on_cpu():
    import dataclasses

    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch.problems import warmup_fleet

    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)
    data = warmup_fleet(4, device="cpu")
    sol = lt.solve_batch_mixed(data, opts, n_corrector_iters=6, escalate=0)
    got = chip_smoke.path_outcome(sol)
    assert got["certified"] == 4 and got["stages"] == {2: 4}
    assert got["iter_total_sum"] == int(sol.stats.iter_total.sum())
    plain = chip_smoke.path_outcome(lt.solve(data, opts))
    assert plain["rets"] == {0: 4} and "stages" not in plain
    assert chip_smoke.strict_audit_failures(lt, data, sol, opts) == []
    # Push lane 2 a hair below a complementarity lower bound: the strict
    # audit names it, with its signed phi and violation.
    Lrow = data.L[2, 0]
    x = sol.x.clone()
    x[2] -= 2e-9 * Lrow
    bad = chip_smoke.strict_audit_failures(
        lt, data, dataclasses.replace(sol, x=x), opts)
    assert [b[0] for b in bad] == [2]
    assert bad[0][2] > 1e-9 and bad[0][3] > 0


def test_api_shapes_are_the_one_call_paths_orders():
    # lcqpow(..., mixed=True) at B = 1 hands the kernel exactly these
    # orders: 2 and 4 on the warm-up, 8 and 14 on random_lcqp(8, 2, 2).
    import collections

    import numpy as np

    import lcqpow_tpu_torch.ops.chol as chol
    from lcqpow_tpu_torch.api import lcqpow
    from lcqpow_tpu_torch.problems import random_lcqp

    seen = collections.Counter()
    orig = chol.gj_inverse

    def record(S):
        seen[tuple(S.shape[:2])] += 1
        return orig(S)

    params = {"printLevel": 0, "perturbStep": False}
    d = random_lcqp(np.random.default_rng(0), nV=8, nC=2, nComp=2,
                    as_numpy=True)
    chol.gj_inverse = record
    try:
        lcqpow([[2., 0.], [0., 2.]], [-2., -2.], [[1., 0.]], [[0., 1.]],
               params=params, mixed=True, device="cpu")
        lcqpow(d.Q, d.g, d.L, d.R, A=d.A, lbA=d.lbA, ubA=d.ubA,
               params=params, mixed=True, device="cpu")
    finally:
        chol.gj_inverse = orig
    assert set(seen) == set(chip_smoke.API_SHAPES)


def test_circle_oracle():
    assert chip_smoke.circle_oracle([0.18111, -0.98348, 5.0])
    assert chip_smoke.circle_oracle([0.9764, -0.2183])
    assert not chip_smoke.circle_oracle([0.1973, -0.9874])    # N = 20 edge
    assert not chip_smoke.circle_oracle([0.5, -0.6])


def test_check_printed_table_on_cpu(capsys):
    import lcqpow_tpu_torch as lt

    lcqp = lt.LCQProblem(2, 0, 1, device="cpu")
    lcqp.set_options(lt.Options(print_level=lt.PrintLevel.INNER_LOOP_ITERATES))
    assert lcqp.load_lcqp([[2., 0.], [0., 2.]], [-2., -2.], [[1., 0.]],
                          [[0., 1.]]) == 0
    assert lcqp.run_solver() == 0
    text = capsys.readouterr().out
    n = lcqp.get_output_statistics().get_iter_total()
    assert chip_smoke.check_printed_table(text, n) == n
    with pytest.raises(AssertionError, match="rows"):
        chip_smoke.check_printed_table(text, n + 1)
    with pytest.raises(AssertionError, match="banner"):
        chip_smoke.check_printed_table(text.replace("S-Stationary", "x"), n)
    with pytest.raises(AssertionError, match="header"):
        chip_smoke.check_printed_table(text.replace("station ", "st "), n)


def test_launches_by_m_reads_and_resets():
    from types import SimpleNamespace

    gj = SimpleNamespace(launch_count=5, launch_counts={14: 3, 8: 2})
    assert chip_smoke.launches_by_m(gj) == {8: 2, 14: 3}
    assert gj.launch_count == 0 and gj.launch_counts == {}
