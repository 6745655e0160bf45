"""weiner_slamit_v2_tpu: a visual SLAM framework in JAX/XLA.

Brand-new implementation of the capability set of the reference
(serviceberry3/weiner_slamit_v2, an Android ORB-SLAM2 fork) — see SURVEY.md.
"""

import jax as _jax

# Geometry/BA numerics need true f32 matmuls: at the default precision an
# f32 product on an NVIDIA GPU may run in TF32 (10-bit mantissa, about three
# decimal digits), which breaks pose-optimization conditioning. Kernels that
# can tolerate lower precision opt in explicitly via lax precision arguments.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import config, geometry, io  # noqa: F401, E402

