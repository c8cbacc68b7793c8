"""The port's stereo-inertial `System` over a KB8 fisheye pair, on the CPU
(the visual one against the JAX package: tests/test_torch_fisheye.py).

A KB8 stereo-inertial run up to IMU init (datasets.synthetic's TUM-VI-like
pair at 320x320, 0.2 m apart, the plane 3 m away, 45 frames, the body 90
deg about z from camera 1). The JAX package falls apart on it: its local
BA's accept test (fasttrack_tpu/optim/local_ba.py:117-121) keeps a step
that moves live observations behind their cameras, and from frame 20 on it
is lost, with no IMU init (`rig_reading.fisheye_system_reading`, ROADMAP
F24). The port rejects such a step in a KB8 window, so it is held to the
truth instead: IMU init reached, |bg| < 0.05 rad/s, every frame but at most
two OK and the last one OK, the frames before the init within 0.02 m, and
the whole run under 0.25 m (it spans the init's change of world; the
trajectory moves 0.38 m RMS).
"""

import numpy as np

from fasttrack_tpu_torch.cameras import make_kannala_brandt8
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from tests.test_torch_system_inertial import ate_rmse, imu_between, one_torch_thread


def test_a_kb8_stereo_inertial_run_reaches_imu_init():
    n = 45
    rig = synthetic.tumvi_kb8_rig(320, 320, baseline=0.2)
    seq = synthetic.generate_sequence(n_frames=n, h=320, w=320, seed=5, rig=rig, plane_z=3.0)
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = rig.R_bc
    settings = Settings(
        camera_type="KannalaBrandt8",
        camera1=make_kannala_brandt8(*rig.params1, 320, 320, device="cpu"),
        camera2=make_kannala_brandt8(*rig.params2, 320, 320, device="cpu"),
        T_c1_c2=rig.T_c1_c2, bf=seq.fx * seq.baseline, baseline=seq.baseline, width=320,
        height=320, n_features=512, n_levels=4, th_depth=60.0, imu_frequency=200.0,
        T_b_c1=T_b_c1)
    system = System(settings, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    states, t_prev = [], -1.0
    with one_torch_thread():
        for f in seq.frames:
            system.track_stereo(f.left, f.right, f.timestamp,
                                imu=imu_between(seq, t_prev, f.timestamp))
            states.append(system.tracking_state.name)
            t_prev = f.timestamp
    system.shutdown()
    assert system.atlas.current.imu_initialized
    assert states.count("OK") >= n - 2 and states[-1] == "OK", states
    assert np.linalg.norm(system.tracker.bias[0]) < 0.05
    traj = system.tracker.trajectory
    before = absolute_trajectory_error(np.asarray([t for t, _, _ in traj[:40]]),
                                       np.asarray([-R.T @ t for _, R, t in traj[:40]]),
                                       seq.gt_t, seq.gt_pos)
    assert before["n"] == 40 and before["rmse"] < 0.02
    assert ate_rmse(seq, system) < 0.25
