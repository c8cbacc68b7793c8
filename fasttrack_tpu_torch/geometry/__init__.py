"""Lie-group math (port of fasttrack_tpu/geometry).

- SO3: rotation matrices (..., 3, 3); tangent phi (..., 3).
- SE3: NamedTuple (R (..., 3, 3), t (..., 3)); tangent [rho, phi] (..., 6).
- Sim3: NamedTuple (R, t, s); tangent [rho, phi, sigma] (..., 7).
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
from fasttrack_tpu_torch.geometry.sim3 import (  # noqa: F401
    Sim3,
    sim3_apply,
    sim3_compose,
    sim3_exp,
    sim3_from_se3,
    sim3_identity,
    sim3_inverse,
    sim3_log,
)
