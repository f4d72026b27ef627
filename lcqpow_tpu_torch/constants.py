"""Numeric constants, mirroring the reference's ``Utilities`` constants.

Source citations in this package (``include/...``, ``src/...``,
``examples/...``) point into the reference LCQPow C++ sources, as in the JAX
package ``lcqpow_tpu``.

Reference: ``include/Utilities.hpp:345-362`` defines
``EPS`` (machine epsilon), ``ZERO`` (treat-as-zero threshold) and ``INFTY``
(stand-in for infinity).  We keep the same values; in particular using a
*finite* ``INFTY`` (1e20) instead of IEEE inf keeps all internal arithmetic
NaN-free (e.g. ``0 * INFTY`` in masked bound arithmetic), which matters for
the branchless, masked batch code of this package.
"""

EPS: float = 2.220446049250313e-16
ZERO: float = 1e-25
INFTY: float = 1e20

# Values at or beyond +/-INFTY are treated as unbounded (reference compares
# with ``<= -INFINITY`` etc. against true IEEE inf; we clamp on ingestion).
MAX_ITERATIONS_DEFAULT: int = 1000
