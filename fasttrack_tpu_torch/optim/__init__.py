"""Motion-only pose optimization (port of fasttrack_tpu/optim, pose only)."""

from fasttrack_tpu_torch.optim.pose_opt import PoseOptResult, pose_optimize  # noqa: F401
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight  # noqa: F401
