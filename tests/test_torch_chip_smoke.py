"""``chip_smoke.py``'s helpers on the CPU: its reading of nvcc's
``-Xptxas -v`` report (on excerpts of the reports for
``lcqpow_tpu_torch/csrc/gj_inverse.cu`` and ``threefry.cu``), its bounds,
its pins and shapes, and its checks of a path's outcome."""

import pytest

import chip_smoke

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0a98d171_13_gj_inverse_cu_f9f6775314gj_wide_kernelILi48EEEvPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0a98d171_13_gj_inverse_cu_f9f6775314gj_wide_kernelILi48EEEvPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 0 barriers
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
    (("gj_wide_kernel", 48, 0), [167, 0, 0]),
    (("gj_warp_kernel", 14, 2), [48, 4, 12]),
])
def test_ptxas_usage_reads_registers_and_spills(key, want):
    usage = chip_smoke.ptxas_usage(LOG, (14, 48))
    assert usage[key] == want
    assert ("gj_warp_kernel", 13, 1) not in usage


def test_check_wide_ptxas():
    usage = chip_smoke.ptxas_usage(LOG, (14, 48))
    chip_smoke.check_wide_ptxas(usage, (14, 48))
    with pytest.raises(AssertionError, match="no full"):
        chip_smoke.check_wide_ptxas(usage, (14, 42, 48))
    spilled = chip_smoke.ptxas_usage(LOG.replace(
        "0 bytes spill stores", "8 bytes spill stores", 1), (48,))
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_wide_ptxas(spilled, (48,))


def test_paths_pin_at_least_the_jax_counts():
    # Each path's pinned outcome certifies at least the JAX package's count
    # (its floor) and accounts for every lane of its fleet.
    lanes = {"pas-mixed-1024": 1024, "pas-warmup-256": 256,
             "circle-N100": chip_smoke.CIRCLE_B,
             "circle-N20-512": chip_smoke.CIRCLE20_B}
    for name, p in chip_smoke.PATHS.items():
        pinned = p["pinned"]
        assert pinned["certified"] >= p["floor"], name
        by = pinned.get("stages") or pinned["rets"]
        assert sum(by.values()) == lanes[name], name
    # The f64 path never reaches the float32 kernel; the circle's inverses
    # are all sweeps (n > 48) at N = 100 and the wide GJ design's order 42
    # at N = 20.
    assert chip_smoke.PATHS["pas-warmup-256"]["pinned"]["launches_by_m"] == {}
    assert chip_smoke.PATHS["circle-N100"]["pinned"]["launches_by_m"] == {}
    assert set(chip_smoke.PATHS["circle-N20-512"]["pinned"][
        "launches_by_m"]) == {chip_smoke.CIRCLE20_NV}
    # Only the circles are audited against a ceiling in place of the strict
    # audit, and the ceiling is no looser than its certificate's bound
    # 1e-9 (1 + max|Ax|) at max|Ax| = 2.
    ceilings = {name: p.get("audit_ceiling")
                for name, p in chip_smoke.PATHS.items()}
    assert ceilings == {"pas-mixed-1024": None, "pas-warmup-256": None,
                        "circle-N100": chip_smoke.CIRCLE_AUDIT_CEILING,
                        "circle-N20-512": chip_smoke.CIRCLE_AUDIT_CEILING}
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
    # circle-N20-512 at full width, and one lane of a retry.
    driven |= {(chip_smoke.CIRCLE20_B, m) for m in
               chip_smoke.PATHS["circle-N20-512"]["pinned"]["launches_by_m"]}
    driven |= {(1, chip_smoke.CIRCLE20_NV)}
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

    params = {"printLevel": 0}
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


def test_launches_by_m_reads_and_resets(monkeypatch):
    from types import SimpleNamespace

    from lcqpow_tpu_torch import prng

    monkeypatch.setattr(prng, "launch_count", 4)
    gj = SimpleNamespace(launch_count=5, launch_counts={14: 3, 8: 2})
    assert chip_smoke.launches_by_m(gj) == {8: 2, 14: 3, "threefry": 4}
    assert gj.launch_count == 0 and gj.launch_counts == {}
    assert prng.launch_count == 0


THREEFRY_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__15f22fe9_11_threefry_cu_b7d9fcd820perturb_apply_kernelIdEEvPKxPKbPKT_PxPS5_iiS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__15f22fe9_11_threefry_cu_b7d9fcd820perturb_apply_kernelIdEEvPKxPKbPKT_PxPS5_iiS5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__15f22fe9_11_threefry_cu_b7d9fcd820perturb_apply_kernelIfEEvPKxPKbPKT_PxPS5_iiS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__15f22fe9_11_threefry_cu_b7d9fcd820perturb_apply_kernelIfEEvPKxPKbPKT_PxPS5_iiS5_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
"""


def test_threefry_ptxas_and_bound():
    import torch

    assert chip_smoke.threefry_ptxas(THREEFRY_LOG) == {"d": [30, 0, 0],
                                                       "f": [24, 4, 4]}
    with pytest.raises(AssertionError):
        chip_smoke.threefry_ptxas("ptxas info    : 0 bytes gmem")
    with pytest.raises(AssertionError):     # one type's report missing
        chip_smoke.threefry_ptxas(THREEFRY_LOG.split("ptxas info    : Used "
                                                     "30")[0])
    # (4096, 8) float32, every lane going: 4096 * (33 + 2 * 32) bytes
    # against 4096 * 20 hashes of 79 integer operations and 8 adds; the
    # operations take longer.
    ms, by = chip_smoke.threefry_bound_ms(4096, 8, 4096, torch.float32)
    ops_ms = (4096 * 20 * 79 / 33.5e12 + 4096 * 8 / 67e12) * 1e3
    assert by == "operations" and ms == pytest.approx(ops_ms, rel=1e-12)
    # No lane going: only the bytes are left, 8 bytes an element in f64.
    ms, by = chip_smoke.threefry_bound_ms(4096, 8, 0, torch.float64)
    assert by == "bytes"
    assert ms == pytest.approx(4096 * (33 + 128) / 3.35e12 * 1e3, rel=1e-12)


def _retry_widths(lanes, stages, rounds, chunk):
    """The lane widths of a path's escalation retries, from its pinned
    stages (0: uncertified, 1-2: certified by the first solve, 3 + r: by
    round r): round r retries the lanes still uncertified, in chunks of
    ``min(chunk, RETRY_CHUNK)`` when the fleet was chunked and that many
    lanes are left, else all at once."""
    from lcqpow_tpu_torch.mixed import RETRY_CHUNK

    left = lanes - stages.get(1, 0) - stages.get(2, 0)
    widths = []
    for r in range(rounds):
        if left == 0:
            break
        c = None if chunk is None else min(chunk, RETRY_CHUNK)
        widths.append(c if c is not None and c <= left else left)
        left -= stages.get(3 + r, 0)
    return widths


def test_threefry_shapes_cover_every_driven_shape():
    # Derived from the paths: the fleets' widths, the circle's chunks, and
    # each escalation round's retry width from the pinned stages; n from
    # the problems themselves.
    from lcqpow_tpu_torch.problems import circle_fleet, warmup_fleet

    cs = chip_smoke
    assert warmup_fleet(1, device="cpu").nV == cs.WARMUP_NV
    assert circle_fleet(1, device="cpu")[0].nV == cs.CIRCLE_NV
    assert circle_fleet(1, device="cpu", N=cs.CIRCLE20_N)[0].nV \
        == cs.CIRCLE20_NV
    wu, circ = cs.WARMUP_NV, cs.CIRCLE_NV
    driven = {(cs.B_MAIN, wu), (cs.PAS_MIXED_B, wu), (cs.PAS_F64_B, wu),
              (cs.CIRCLE_CHUNK, circ)}
    # main: escalate=1, not chunked at m = 14; the circle: escalate=3.
    driven |= {(b, wu) for b in _retry_widths(
        cs.B_MAIN, cs.MAIN_EXPECTED["stages"], 1, None)}
    driven |= {(b, circ) for b in _retry_widths(
        cs.CIRCLE_B, cs.PATHS["circle-N100"]["pinned"]["stages"], 3,
        cs.CIRCLE_CHUNK)}
    # The api phase: the circle through LCQProblem, the one-call path's
    # warm-up (n = 2) and random_lcqp(8, 2, 2), one instance each.
    driven |= {(1, circ), (1, 2), (1, wu)}
    assert driven <= set(cs.THREEFRY_SHAPES)
    assert (cs.B_MAIN - 1, wu) in cs.THREEFRY_SHAPES      # a ragged batch
    assert len(set(cs.THREEFRY_SHAPES)) == len(cs.THREEFRY_SHAPES)


def test_retry_widths():
    # The circle's pinned split: 27 lanes left after the first solve, 11
    # after round 0, 5 after round 1 (fewer than a chunk).
    assert _retry_widths(128, {0: 4, 2: 101, 3: 16, 4: 6, 5: 1}, 3,
                         32) == [8, 8, 5]
    assert _retry_widths(4096, {2: 4095, 3: 1}, 1, None) == [1]
    assert _retry_widths(64, {2: 64}, 3, 32) == []


@pytest.mark.parametrize("B,n", [(5, 8), (1, 202), (3, 0)])
def test_hold_threefry_on_cpu(B, n):
    import torch

    from lcqpow_tpu_torch import prng

    for dtype in chip_smoke.THREEFRY_DTYPES:
        keys, go, xk, err = chip_smoke.hold_threefry(prng, B, n, dtype,
                                                     device="cpu")
        assert tuple(keys.shape) == (B, 2) and bool(go[0]) and err == 0.0
        assert xk.dtype == dtype and tuple(xk.shape) == (B, n)
        if n >= 6:
            # -0, +0, two subnormals and +-1 among the first six elements.
            head = xk[0, :6:3]
            assert torch.signbit(head[0]) and head[0] == 0
            tiny = torch.finfo(dtype).smallest_normal
            assert 0 < abs(float(xk.view(-1)[6])) < tiny


def _matvec_entry(mangled, regs, spills=0):
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


def test_matvec_ptxas_reads_every_matvec_kernel():
    pre = "_ZN38_GLOBAL__N__bd312f89_9_matvec_cu_4e0a078813"
    tiled = [(m, n, t) for m, n, t in chip_smoke.MATVEC_SHAPES
             if (m, n) != (2, 8)]
    log = "".join(
        _matvec_entry(f"{pre}matvec_kernelILi{m}ELi{n}ELb{int(t)}EEEvPKfS2_"
                      f"Pfixxxxiii", 40 + m)
        for m, n, t in tiled)
    lane = f"{pre[:-2]}18matvec_lane_kernelILi2ELi8EEEvPKfS2_Pfiiii"
    usage = chip_smoke.matvec_ptxas(log + _matvec_entry(lane, 32))
    assert usage[("matvec_kernel", 14, 8, True)] == [54, 0, 0]
    assert usage[("matvec_kernel", 14, 8, False)] == [54, 0, 0]
    assert usage[("matvec_lane_kernel", 2, 8, False)] == [32, 0, 0]
    assert len(usage) == len(chip_smoke.MATVEC_SHAPES)
    # A report without the one-thread-a-lane kernel is not a full report,
    # nor is one with a tiled kernel at (2, 8), which the library no
    # longer builds.
    with pytest.raises(AssertionError, match="no full"):
        chip_smoke.matvec_ptxas(log)
    extra = _matvec_entry(f"{pre}matvec_kernelILi2ELi8ELb0EEEvPKfS2_"
                          f"Pfixxxxiii", 42)
    with pytest.raises(AssertionError, match="no full"):
        chip_smoke.matvec_ptxas(log + extra + _matvec_entry(lane, 32))


def test_matvec_bound_moves_each_byte_once():
    # (B, 14, 8) mv: 112 matrix floats, 8 vector floats and 14 outputs a
    # lane; mtv: 14 vector floats and 8 outputs.  The same bytes either way.
    B = chip_smoke.MATVEC_B
    want = B * (112 + 8 + 14) * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert chip_smoke.matvec_bound_ms(B, 14, 8, False) == pytest.approx(want)
    assert chip_smoke.matvec_bound_ms(B, 14, 8, True) == pytest.approx(want)
    assert chip_smoke.matvec_bound_ms(B, 2, 8, False) == pytest.approx(
        B * (16 + 8 + 2) * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3)
