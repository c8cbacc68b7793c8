"""Lie-group math (port of fasttrack_tpu/geometry, SO3 and SE3 only).

- SO3: rotation matrices (..., 3, 3); tangent phi (..., 3).
- SE3: NamedTuple (R (..., 3, 3), t (..., 3)); tangent [rho, phi] (..., 6).
"""

from fasttrack_tpu_torch.geometry.so3 import hat, so3_exp, so3_log, vee  # noqa: F401
from fasttrack_tpu_torch.geometry.se3 import (  # noqa: F401
    SE3,
    se3_apply,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
    se3_matrix,
)
