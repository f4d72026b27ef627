#!/usr/bin/env python3
"""Time the step perturbation kernel (``prng.perturb_apply``) of several
checkouts, in turns, on one card.

Run from the root of a checkout, with one NVIDIA card visible::

    python3 tools/torch_perturb_times.py VARIANT . . VARIANT

Each TREE argument (a directory holding ``lcqpow_tpu_torch/`` and
``chip_smoke.py``, e.g. a copy with another ``csrc/threefry.cu``) gets a
fresh Python process of its own, in the order given.  The process builds
that tree's kernels and, at the driven paths' shapes (4096, 8), (1024, 8),
(256, 8) and (32, 202) in float32 and float64, holds the kernel bitwise
against its plain version (``chip_smoke.hold_threefry``) and reads its
device ms per call with ``chip_smoke.device_ms`` over 200 calls: with the
L2 cache flushed before each call, and warm.  One JSON line per process
(the tree, then "B,n,dtype" -> [flushed, warm]), then the card's name and
power limit as ``nvidia-smi`` prints them.  Exits non-zero when a process
fails or without a card.
"""

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from lcqpow_tpu_torch import _build, prng

_build.build_all()
l2 = torch.empty(cs.FLUSH_FLOATS, device="cuda")
out = {}
for B, n in [(4096, 8), (1024, 8), (256, 8), (32, 202)]:
    for dt in cs.THREEFRY_DTYPES:
        keys, go, xk, _ = cs.hold_threefry(prng, B, n, dt)
        eps = torch.finfo(dt).eps
        f = lambda: prng.perturb_apply(keys, go, xk, eps)
        out[f"{B},{n},{str(dt)[6:]}"] = [
            cs.device_ms(f, 200, kernel="perturb_apply", flush=l2.zero_),
            cs.device_ms(f, 200, kernel="perturb_apply")]
print(json.dumps(out))
"""


def main():
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print("usage: torch_perturb_times.py TREE [TREE ...] (needs a CUDA "
              "card)", file=sys.stderr)
        return 1
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": os.path.normpath(tree)} | res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
