"""The least device time of the port's kernels at a call's shapes, from
the published peaks of the card (``peaks.json``).

Copied from ``chip_smoke.py``'s ``bound_ms`` and ``threefry_bound_ms``,
so that a later change to the program's smoke test does not move the
yardstick.  Each input byte is read once and each output byte written
once; the operations are those the algorithm needs for the call.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def gj_bound_s(B: int, m: int) -> float:
    """One batched inverse of B (m, m) float32 matrices: 2·B·m²·4 bytes at
    the HBM rate, or 2·m³·B operations at the FP32 rate, whichever takes
    longer."""
    bytes_s = 2 * B * m * m * 4 / PEAKS["hbm_bytes_per_s"]
    ops_s = 2 * m ** 3 * B / PEAKS["fp32_ops_per_s"]
    return max(bytes_s, ops_s)


def perturb_bound_s(B: int, n: int, n_going: int, size: int) -> float:
    """One pass's perturbation of B lanes of n elements of ``size`` bytes,
    ``n_going`` of them perturbed: keys in and out (16 bytes a lane each
    way), the mask (1 byte a lane), the iterate in and out, moved once; or
    (4 + 2n) Threefry hashes and n adds for each going lane at the
    integer and floating-point peak rates, whichever takes longer."""
    bytes_s = (B * 33 + 2 * B * n * size) / PEAKS["hbm_bytes_per_s"]
    flops = PEAKS["fp64_ops_per_s"] if size == 8 else PEAKS["fp32_ops_per_s"]
    ops_s = (n_going * (4 + 2 * n) * PEAKS["int32_ops_per_hash"]
             / PEAKS["int32_ops_per_s"] + n_going * n / flops)
    return max(bytes_s, ops_s)
