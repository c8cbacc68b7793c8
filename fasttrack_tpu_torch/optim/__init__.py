"""Nonlinear optimization (port of fasttrack_tpu/optim): motion-only pose
optimization and the local bundle adjustment, as Levenberg-Marquardt with
masked residuals and Schur-complement reduction; their visual-inertial
counterparts are in optim/inertial.py."""

from fasttrack_tpu_torch.optim.pose_opt import PoseOptResult, pose_optimize  # noqa: F401
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight  # noqa: F401
from fasttrack_tpu_torch.optim.local_ba import (  # noqa: F401
    BAProblem,
    BAResult,
    local_bundle_adjustment,
)
