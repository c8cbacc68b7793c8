"""Camera models (port of fasttrack_tpu/cameras/models.py)."""

from fasttrack_tpu_torch.cameras.models import (  # noqa: F401
    FISHEYE_KB8,
    PINHOLE,
    Camera,
    make_kannala_brandt8,
    make_pinhole,
    project,
    unproject,
)
