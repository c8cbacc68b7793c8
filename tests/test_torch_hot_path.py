"""The port's whole tracking hot path against the JAX package.

Both packages run tracking_hot_path at 240x320, 4 levels, 256 features
per camera, against the same local map built from the first frame's
stereo keypoints (JAX's), on the second frame. Tolerances and why (the
golden-check thresholds where they apply):
- keypoint (x, y, level) set overlap >= 0.97: tie order may move a slot;
- median stereo depth difference on co-detected keypoints <= 0.05 m;
- number of accepted search matches within 3%;
- pose rotation and translation within 1e-3: f32 rounding through 40 LM
  steps on slightly different inputs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu import frame_pipeline as jfp
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.geometry import se3_identity as jax_se3_identity
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu_torch import convert, parity
from fasttrack_tpu_torch import frame_pipeline as tfp
from fasttrack_tpu_torch.ops.extractor import OrbConfig

H, W = 240, 320
JCFG = JaxOrbConfig(height=H, width=W, n_features=256, n_levels=4)
CFG = OrbConfig(**JCFG._asdict())
INTRINSICS = (230.0, 230.0, 160.0, 120.0)
BF, MIN_Z = np.float32(0.11 * 230.0), np.float32(0.11)
N_MAP = 384
MAP_KEYS = ("u", "v", "desc", "pos", "radius", "lmin", "lmax", "ok")


def frame_dict(fd):
    k = fd.kps
    return {
        "x": np.asarray(k.x), "y": np.asarray(k.y), "level": np.asarray(k.level),
        "valid": np.asarray(k.valid), "desc_packed": np.asarray(k.desc_packed),
        "depth": np.asarray(fd.depth),
    }


@pytest.fixture(scope="module")
def runs():
    f0, f1 = parity.stereo_frames(2, H, W, seed=11)
    bf, min_z = jnp.float32(BF), jnp.float32(MIN_Z)
    fd0 = jfp.process_stereo_frame_stacked(jnp.asarray(f0), JCFG, bf, min_z)
    mp = parity.map_from_frame(frame_dict(fd0), INTRINSICS, N_MAP, CFG.n_levels, shift=(-5.0, -3.0))
    cam_j = jax_make_pinhole(*INTRINSICS, W, H)
    want = jfp.tracking_hot_path(
        jnp.asarray(f1), JCFG, bf, min_z, cam_j, jax_se3_identity(),
        *(jnp.asarray(mp[k]) for k in MAP_KEYS),
    )
    cam_t = convert.camera_from_numpy("pinhole", np.asarray(cam_j.params), W, H, device="cpu")
    got = tfp.tracking_hot_path(
        torch.from_numpy(f1), CFG, torch.tensor(BF), torch.tensor(MIN_Z), cam_t,
        convert.se3_from_numpy(np.eye(3), np.zeros(3), device="cpu"),
        *convert.map_from_numpy(**mp, device="cpu"),
    )
    return want, got, mp


def test_frame_matches_jax(runs):
    (fd_j, _, _), (fd_t, _, _), _ = runs
    a, b = frame_dict(fd_j), frame_dict(fd_t)
    report = parity.golden_compare(a, b)
    assert report["kp_set_match"] >= parity.MIN_KP_OVERLAP, report
    assert report["desc_mean_bits_diff"] <= parity.MAX_DESC_BITS, report
    assert min(report["n_stereo"]) > 50, report
    assert report["depth_med_absdiff_m"] <= parity.MAX_DEPTH_DIFF_M, report
    assert int(fd_t.n_valid) == int(fd_j.n_valid)


def test_search_and_pose_match_jax(runs):
    (_, res_j, opt_j), (_, res_t, opt_t), mp = runs
    n_j, n_t = int(np.asarray(res_j.ok).sum()), int(res_t.ok.sum())
    assert n_j > 0.5 * mp["ok"].sum()
    assert abs(n_t - n_j) <= 0.03 * n_j, (n_t, n_j)
    np.testing.assert_allclose(opt_t.pose.R.numpy(), np.asarray(opt_j.pose.R), rtol=0, atol=1e-3)
    np.testing.assert_allclose(opt_t.pose.t.numpy(), np.asarray(opt_j.pose.t), rtol=0, atol=1e-3)
    # the view moved: the pose left identity
    assert np.abs(opt_t.pose.t.numpy()).max() > 1e-2


def test_packed_fetch_roundtrip(runs):
    _, (fd, res, opt), mp = runs
    buf = tfp.pack_hot_path_for_host(fd, res, opt)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    host = tfp.unpack_hot_path(buf.numpy(), CFG.total_features, N_MAP)
    f32, desc = tfp.pack_frame_for_host(fd)
    np.testing.assert_array_equal(host["x"], f32[0].numpy())
    np.testing.assert_array_equal(host["depth"], fd.depth.numpy())
    np.testing.assert_array_equal(host["valid"], fd.kps.valid.numpy())
    np.testing.assert_array_equal(host["desc_packed"], desc.numpy())
    np.testing.assert_array_equal(host["match_idx"], res.idx.numpy())
    np.testing.assert_array_equal(host["match_ok"], res.ok.numpy())
    np.testing.assert_array_equal(host["R"], opt.pose.R.numpy())
    np.testing.assert_array_equal(host["t"], opt.pose.t.numpy())
    np.testing.assert_array_equal(host["inliers"], opt.inliers.numpy())
    assert host["n_inliers"] == int(opt.n_inliers)
