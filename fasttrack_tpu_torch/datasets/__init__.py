"""Sequence sources: the synthetic renderer (datasets/synthetic.py) and the
EuRoC, TUM-VI, KITTI and TUM RGB-D directory loaders (datasets/loaders.py)."""

from fasttrack_tpu_torch.datasets.loaders import (  # noqa: F401
    EurocSequence,
    ImuData,
    KittiSequence,
    TumRgbdSequence,
    TumViSequence,
    load_image,
)
from fasttrack_tpu_torch.datasets.synthetic import generate_sequence  # noqa: F401
