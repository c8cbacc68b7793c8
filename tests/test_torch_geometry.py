"""The port's SO3/SE3 and camera models against the JAX package.

Both sides run the same f32 formulas (the port with TF32 off), so they
agree to f32 rounding: within 1e-5 absolute plus 1e-5 relative. The
relative part covers pixel coordinates (hundreds of pixels carry an f32
spacing of ~6e-5) and logs of rotations near pi, where arccos amplifies
the last bit of the trace.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import fasttrack_tpu.cameras as jcam
import fasttrack_tpu.geometry as jgeo
import fasttrack_tpu_torch.cameras as tcam
import fasttrack_tpu_torch.geometry as tgeo
from fasttrack_tpu_torch import convert

TOL = dict(rtol=1e-5, atol=1e-5)


def rotvecs(rng, n=64, near_pi=False):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if near_pi:
        return (v * (np.pi - 1e-4)).astype(np.float32)
    v *= rng.uniform(0.0, np.pi - 0.05, size=(n, 1))
    v[:1] = 0.0           # identity
    v[1:2] = [1e-9, 0, 0]  # tiny angle
    return v.astype(np.float32)


def tangents(rng, n=64):
    return np.concatenate([rng.normal(size=(n, 3)), rotvecs(rng, n)], -1).astype(np.float32)


def jax_se3(T):
    return jgeo.SE3(jnp.asarray(np.asarray(T.R)), jnp.asarray(np.asarray(T.t)))


def assert_se3_close(Tt, Tj):
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), **TOL)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), **TOL)


def test_hat_and_exp(rng):
    phi = rotvecs(rng)
    np.testing.assert_array_equal(tgeo.hat(torch.from_numpy(phi)).numpy(), np.asarray(jgeo.hat(phi)))
    np.testing.assert_allclose(
        tgeo.so3_exp(torch.from_numpy(phi)).numpy(), np.asarray(jgeo.so3_exp(phi)), **TOL
    )


@pytest.mark.parametrize("near_pi", [False, True])
def test_so3_log(rng, near_pi):
    R = np.asarray(jgeo.so3_exp(rotvecs(rng, near_pi=near_pi)))
    want = np.asarray(jgeo.so3_log(jnp.asarray(R)))
    got = tgeo.so3_log(torch.from_numpy(R.copy())).numpy()
    if near_pi:  # at theta ~ pi, phi and -phi are the same rotation
        flip = np.sum(got * want, -1) < 0
        got[flip] *= -1
    np.testing.assert_allclose(got, want, **TOL)


def test_se3_exp_log(rng):
    xi = tangents(rng)
    Tt = tgeo.se3_exp(torch.from_numpy(xi))
    Tj = jgeo.se3_exp(jnp.asarray(xi))
    assert_se3_close(Tt, Tj)
    np.testing.assert_allclose(tgeo.se3_log(Tt).numpy(), np.asarray(jgeo.se3_log(Tj)), **TOL)


def test_se3_compose_inverse_apply_matrix(rng):
    A = tgeo.se3_exp(torch.from_numpy(tangents(rng, 16)))
    B = tgeo.se3_exp(torch.from_numpy(tangents(rng, 16)))
    X = rng.normal(size=(16, 3)).astype(np.float32) * 5
    assert_se3_close(tgeo.se3_compose(A, B), jgeo.se3_compose(jax_se3(A), jax_se3(B)))
    assert_se3_close(tgeo.se3_inverse(A), jgeo.se3_inverse(jax_se3(A)))
    np.testing.assert_allclose(
        tgeo.se3_apply(A, torch.from_numpy(X)).numpy(),
        np.asarray(jgeo.se3_apply(jax_se3(A), jnp.asarray(X))), **TOL,
    )
    np.testing.assert_allclose(
        tgeo.se3_matrix(A).numpy(), np.asarray(jgeo.se3_matrix(jax_se3(A))), **TOL
    )
    I = tgeo.se3_identity(device="cpu")
    np.testing.assert_array_equal(I.R.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(I.t.numpy(), np.zeros(3, np.float32))


def test_se3_from_numpy(rng):
    T = jgeo.se3_exp(jnp.asarray(tangents(rng, 1)[0]))
    assert_se3_close(convert.se3_from_numpy(np.asarray(T.R), np.asarray(T.t), device="cpu"), T)


def points(rng, n=256):
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * rng.uniform(0.5, 20.0, size=(n, 1))).astype(np.float32)


CAMERAS = {
    "pinhole": jcam.make_pinhole(458.654, 457.296, 367.215, 248.375, 752, 480),
    "kb8": jcam.make_kannala_brandt8(
        190.97847, 190.9733, 254.93170, 256.89741,
        0.0034823894, 0.0007150348, -0.0020532361, 0.00020293673, 512, 512,
    ),
}


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_project(rng, kind):
    cj = CAMERAS[kind]
    ct = convert.camera_from_numpy(cj.kind, np.asarray(cj.params), cj.width, cj.height, device="cpu")
    X = points(rng)
    np.testing.assert_allclose(
        tcam.project(ct, torch.from_numpy(X)).numpy(),
        np.asarray(jcam.project(cj, jnp.asarray(X))), **TOL,
    )


def test_make_pinhole_and_unproject(rng):
    cj = CAMERAS["pinhole"]
    ct = tcam.make_pinhole(458.654, 457.296, 367.215, 248.375, 752, 480, device="cpu")
    np.testing.assert_array_equal(ct.params.numpy(), np.asarray(cj.params))
    uv = np.array(jcam.project(cj, jnp.asarray(points(rng))))
    np.testing.assert_allclose(
        tcam.unproject(ct, torch.from_numpy(uv)).numpy(),
        np.asarray(jcam.unproject(cj, jnp.asarray(uv))), **TOL,
    )
