"""Global numeric configuration and device selection for lcqpow_tpu_torch.

The counterpart of ``lcqpow_tpu/_config.py``.  The reference solver (LCQPow)
runs in IEEE double precision and its default tolerances are multiples of
DBL_EPSILON (``src/Options.cpp:296-298``), so problem data defaults to
float64 (:func:`default_dtype`), as the JAX package does with x64 enabled.

Matmul precision: every accuracy-bearing path (the polish's KKT acceptance at
~1e-5 tolerances, the double-word-f32 arithmetic whose error-free
transformations assume *exact* f32 products, the final certification) breaks
under TF32, which keeps about three decimal digits.  PyTorch's f32 matmuls
are full f32 by default but cuDNN's are not, so both are pinned here, the
counterpart of the JAX package's ``jax_default_matmul_precision="highest"``.

Device policy: the port's entry points run on the CUDA card unless the caller
asks for the CPU with ``device="cpu"`` (:func:`default_device`).  There is no
silent fallback to the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_dtype() -> torch.dtype:
    """Default floating dtype of problem data: float64."""
    return torch.float64


def default_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``device=None`` means the current CUDA card, and raises if there is
    none; any explicit value (``"cpu"``, ``"cuda:0"``, a ``torch.device``)
    is taken as given.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lcqpow_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
