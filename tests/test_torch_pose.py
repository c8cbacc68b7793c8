"""The port's motion-only pose optimization against the JAX package, on the
cases of tests/test_optim.py::TestPoseOptimize.

The port differentiates the residual analytically where the JAX package
uses jax.jacfwd, and sums the normal equations in another order, so the
two poses agree to f32 rounding carried through 40 LM steps: rotation and
translation within 1e-4. The inlier masks must be equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu.cameras import make_pinhole, project
from fasttrack_tpu.geometry import se3_apply, se3_compose, se3_exp
from fasttrack_tpu.optim import pose_optimize as jax_pose_optimize
from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.optim import pose_optimize

CAM = make_pinhole(458.0, 457.0, 376.0, 240.0, 752, 480)
BF = 47.9


def make_case(rng, n=256, noise=0.5, outlier_frac=0.2, stereo=True):
    X = np.stack(
        [rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4.0, 12.0, n)], -1
    ).astype(np.float32)
    T_true = se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03, 0.01], jnp.float32))
    Xc = se3_apply(T_true, jnp.asarray(X))
    uv = np.array(project(CAM, Xc))
    ur = uv[:, 0] - BF / np.asarray(Xc[:, 2])
    uv += rng.normal(size=(n, 2)).astype(np.float32) * noise
    n_out = int(n * outlier_frac)
    uv[rng.choice(n, n_out, replace=False)] += rng.uniform(15, 40, size=(n_out, 2)).astype(np.float32)
    if not stereo:
        ur = np.full(n, -1.0, np.float32)
    T0 = se3_compose(
        se3_exp(jnp.asarray([0.05, 0.05, -0.05, 0.01, 0.02, -0.01], jnp.float32)), T_true
    )
    return X, uv.astype(np.float32), ur.astype(np.float32), T0


CASES = {
    "stereo": dict(),
    "mono": dict(stereo=False),
    "noise_free": dict(n=64, noise=0.0, outlier_frac=0.0),
    "heavy_outliers": dict(outlier_frac=0.4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pose_matches_jax(rng, case):
    X, uv, ur, T0 = make_case(rng, **CASES[case])
    n = X.shape[0]
    inv_sigma2 = rng.choice(np.asarray([1.0, 1 / 1.44, 1 / 2.0736], np.float32), n)
    valid = np.ones(n, bool)
    valid[:3] = False
    want = jax_pose_optimize(
        CAM, jnp.float32(BF), T0, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(ur),
        jnp.asarray(inv_sigma2), jnp.asarray(valid),
    )
    cam = convert.camera_from_numpy(
        CAM.kind, np.asarray(CAM.params), CAM.width, CAM.height, device="cpu"
    )
    got = pose_optimize(
        cam, torch.tensor(BF), convert.se3_from_numpy(np.asarray(T0.R), np.asarray(T0.t), device="cpu"),
        *(torch.from_numpy(a) for a in (X, uv, ur, inv_sigma2, valid)),
    )
    np.testing.assert_allclose(got.pose.R.numpy(), np.asarray(want.pose.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(want.pose.t), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
