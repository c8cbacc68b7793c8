"""Map data model (the reference's L1: Atlas > Map > KeyFrame/MapPoint).

Port of fasttrack_tpu/slam_map (host code on NumPy, no tensors).
Host-side Python objects orchestrating device-resident arrays: keypoint /
descriptor tensors live on the device inside Frame snapshots; the graph
structure (covisibility, spanning tree, observations) is plain Python — the
same CPU/accelerator split the reference uses (graph on host, dense math on
GPU).
"""

from fasttrack_tpu_torch.slam_map.mappoint import MapPoint  # noqa: F401
from fasttrack_tpu_torch.slam_map.keyframe import KeyFrame  # noqa: F401
from fasttrack_tpu_torch.slam_map.map import Map  # noqa: F401
from fasttrack_tpu_torch.slam_map.atlas import Atlas  # noqa: F401
