"""Trajectory evaluation (replaces the reference's absent evaluate3.py)."""

from fasttrack_tpu_torch.evaluation.ate import (  # noqa: F401
    umeyama_alignment,
    absolute_trajectory_error,
    associate_trajectories,
    evaluate_trajectory,
    load_ground_truth,
    report_ate,
)
