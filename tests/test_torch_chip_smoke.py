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
