"""Per-stage offload toggles — the reference's KernelController.

The reference (src/Kernels/KernelController.cu:31-37, include/Kernels/
KernelController.h:19-23) keeps five global booleans, set from positional CLI
flags before System construction, that select a GPU or CPU implementation for
each tracking stage:

    orbExtraction, stereoMatch, searchLocalPoints, poseEstimation,
    poseOptimization (the last one *bypasses* pose optimization when off,
    Tracking.cc:3080-3106 — the FastTrack "bypass PO" mode).

Port of fasttrack_tpu/kernels.py. Here the same ablation API selects between
the device path (PyTorch and the CUDA kernels on the tensors' device) and a
host (NumPy / native C++) path per stage: `ops/host_kernels.py` over the
port's native library (`native.py`), dispatched by the tracker. A toggle that
is on never runs the host path and one that is off never runs the device's.
`poseOptimization=False` skips pose optimization inside TrackLocalMap,
exactly like the reference.

Unlike the reference's process-global statics the toggles live in a small
config object threaded through the System, so several systems can coexist;
a module-level default (`set_run_mode` / `get_run_mode`) mirrors the
reference's static-before-System idiom.
"""

from __future__ import annotations

import dataclasses
import enum


class Stage(enum.Enum):
    ORB_EXTRACTION = "orb_extraction"
    STEREO_MATCH = "stereo_match"
    SEARCH_LOCAL_POINTS = "search_local_points"
    POSE_ESTIMATION = "pose_estimation"
    POSE_OPTIMIZATION = "pose_optimization"


@dataclasses.dataclass
class KernelConfig:
    """Offload toggles, mirroring KernelController.h:19-23.

    True  -> device path (PyTorch ops and the hand-written CUDA kernels)
    False -> host path (NumPy / native C++ fallback)

    ``pose_optimization`` is a run/skip toggle, not an offload toggle
    (Tracking.cc:3080-3106): False disables pose optimization in
    TrackLocalMap ("bypass PO").
    """

    orb_extraction: bool = True
    stereo_match: bool = True
    search_local_points: bool = True
    pose_estimation: bool = True
    pose_optimization: bool = True

    @classmethod
    def from_bitmask(cls, mask: str, pose_optimization: bool = True) -> "KernelConfig":
        """Parse the reference harness's 4-bit mode string, e.g. '1100'.

        Bit order matches run_experiments.sh / BASELINE.md:
        (orbExtraction, stereoMatch, searchLocalPoints, poseEstimation).
        """
        if len(mask) != 4 or any(c not in "01" for c in mask):
            raise ValueError(f"mode bitmask must be 4 chars of 0/1, got {mask!r}")
        return cls(
            orb_extraction=mask[0] == "1",
            stereo_match=mask[1] == "1",
            search_local_points=mask[2] == "1",
            pose_estimation=mask[3] == "1",
            pose_optimization=pose_optimization,
        )

    def offloaded(self, stage: Stage) -> bool:
        return bool(getattr(self, stage.value))


# Module-level default, mirroring KernelController::setGPURunMode's
# set-before-System-construction usage (stereo_inertial_euroc.cc:55-69).
_default = KernelConfig()


def set_run_mode(config: KernelConfig) -> None:
    global _default
    _default = config


def get_run_mode() -> KernelConfig:
    return _default
