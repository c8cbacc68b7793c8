"""Camera models (port of fasttrack_tpu/cameras/models.py) and their host
mirror (cameras/host.py)."""

from fasttrack_tpu_torch.cameras.host import (  # noqa: F401
    HostCamera,
    frustum_depth_ok,
    host_camera,
    in_image_np,
    project_np,
    unproject_np,
)
from fasttrack_tpu_torch.cameras.models import (  # noqa: F401
    FISHEYE_KB8,
    PINHOLE,
    Camera,
    make_kannala_brandt8,
    make_pinhole,
    project,
    project_jacobian,
    project_point,
    uncertainty2,
    unproject,
)
from fasttrack_tpu_torch.cameras.stereo import (  # noqa: F401
    StereoRig,
    make_rectified_rig,
    triangulate_matches,
)
