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


def sim3_tangents(rng, n=64):
    """[rho, phi, sigma]: the small-angle and small-scale branches included."""
    sigma = rng.normal(scale=0.5, size=(n, 1))
    sigma[:3] = 0.0
    sigma[3:4] = 1e-8
    return np.concatenate([tangents(rng, n), sigma], -1).astype(np.float32)


def jax_sim3(S):
    return jgeo.Sim3(*(jnp.asarray(np.asarray(x)) for x in S))


def assert_sim3_close(St, Sj):
    for a, b in zip(St, Sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_sim3_exp_log(rng):
    """geometry/sim3.py against the JAX module, float32 on both sides (the
    port needs no precision pin: TF32 is off), tolerance TOL."""
    xi = sim3_tangents(rng)
    St = tgeo.sim3_exp(torch.from_numpy(xi))
    Sj = jgeo.sim3_exp(jnp.asarray(xi))
    assert_sim3_close(St, Sj)
    np.testing.assert_allclose(tgeo.sim3_log(St).numpy(), np.asarray(jgeo.sim3_log(Sj)), **TOL)
    np.testing.assert_allclose(tgeo.sim3_log(St).numpy(), xi, **TOL)     # the round trip


def test_sim3_compose_inverse_apply(rng):
    A = tgeo.sim3_exp(torch.from_numpy(sim3_tangents(rng, 16)))
    B = tgeo.sim3_exp(torch.from_numpy(sim3_tangents(rng, 16)))
    X = rng.normal(size=(16, 3)).astype(np.float32) * 5
    assert_sim3_close(tgeo.sim3_compose(A, B), jgeo.sim3_compose(jax_sim3(A), jax_sim3(B)))
    assert_sim3_close(tgeo.sim3_inverse(A), jgeo.sim3_inverse(jax_sim3(A)))
    np.testing.assert_allclose(
        tgeo.sim3_apply(A, torch.from_numpy(X)).numpy(),
        np.asarray(jgeo.sim3_apply(jax_sim3(A), jnp.asarray(X))), **TOL,
    )
    I = tgeo.sim3_compose(A, tgeo.sim3_inverse(A))
    assert_sim3_close(I, jgeo.sim3_identity((16,)))


def test_sim3_identity_and_se3(rng):
    from fasttrack_tpu.geometry.sim3 import sim3_to_se3 as jax_sim3_to_se3
    from fasttrack_tpu_torch.geometry.sim3 import sim3_to_se3

    I = tgeo.sim3_identity((2,), device="cpu")
    assert_sim3_close(I, jgeo.sim3_identity((2,)))
    T = tgeo.se3_exp(torch.from_numpy(tangents(rng, 8)))
    assert_sim3_close(tgeo.sim3_from_se3(T), jgeo.sim3_from_se3(jax_se3(T)))
    S = tgeo.sim3_exp(torch.from_numpy(sim3_tangents(rng, 8)))
    assert_se3_close(sim3_to_se3(S), jax_sim3_to_se3(jax_sim3(S)))


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


# ------------------------------------------- the public API's rest (M9f)
def test_quaternions_equal_jax(rng):
    """quat_to_matrix and matrix_to_quat ([w, x, y, z], w >= 0) on seeded
    rotations, those near pi about each axis included (each of the four
    Shepperd branches), within TOL."""
    phi = np.concatenate([rotvecs(rng), rotvecs(rng, near_pi=True),
                          np.float32([[3.1, 0, 0], [0, 3.1, 0], [0, 0, 3.1]])])
    R = np.asarray(jgeo.so3_exp(phi))
    got = tgeo.matrix_to_quat(torch.from_numpy(R.copy())).numpy()
    want = np.asarray(jgeo.matrix_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[:, 0] >= 0).all()
    q = rng.normal(size=(64, 4)).astype(np.float32)        # not unit: both normalize
    np.testing.assert_allclose(tgeo.quat_to_matrix(torch.from_numpy(q)).numpy(),
                               np.asarray(jgeo.quat_to_matrix(jnp.asarray(q))), **TOL)
    np.testing.assert_allclose(tgeo.quat_to_matrix(torch.from_numpy(got)).numpy(), R, **TOL)


def test_normalize_rotation_equals_jax(rng):
    """Near-rotations (1e-3 noise) and reflections with distinct singular
    values (-R diag(1, 0.9, 0.8), whose nearest rotation is unique) projected
    onto SO(3), within TOL; the result is a rotation."""
    import fasttrack_tpu.geometry.so3 as jso3

    R = np.asarray(jgeo.so3_exp(rotvecs(rng)))
    M = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    M[:8] = -(R[:8] @ np.diag([1.0, 0.9, 0.8]).astype(np.float32))
    got = tgeo.normalize_rotation(torch.from_numpy(M.copy())).numpy()
    np.testing.assert_allclose(got, np.asarray(jso3.normalize_rotation(jnp.asarray(M))), **TOL)
    np.testing.assert_allclose(np.linalg.det(got.astype(np.float64)), 1.0, atol=1e-5)


def test_se3_adjoint_boxplus_and_from_matrix_equal_jax(rng):
    import fasttrack_tpu.geometry.se3 as jse3

    Tt = tgeo.se3_exp(torch.from_numpy(tangents(rng)))
    Tj = jax_se3(Tt)
    np.testing.assert_allclose(tgeo.se3_adjoint(Tt).numpy(),
                               np.asarray(jse3.se3_adjoint(Tj)), **TOL)
    xi = tangents(rng) * 0.1
    assert_se3_close(tgeo.se3_boxplus(Tt, torch.from_numpy(xi)),
                     jse3.se3_boxplus(Tj, jnp.asarray(xi)))
    M = tgeo.se3_matrix(Tt)
    back = tgeo.se3_from_matrix(M)
    np.testing.assert_array_equal(back.R.numpy(), Tt.R.numpy())
    np.testing.assert_array_equal(back.t.numpy(), Tt.t.numpy())
    assert_se3_close(back, jgeo.se3_from_matrix(jnp.asarray(M.numpy())))


def test_so3_jacobians_are_exported_and_equal_jax(rng):
    phi = rotvecs(rng)
    for name in ("so3_left_jacobian", "so3_right_jacobian"):
        np.testing.assert_allclose(getattr(tgeo, name)(torch.from_numpy(phi)).numpy(),
                                   np.asarray(getattr(jgeo, name)(jnp.asarray(phi))), **TOL)


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_project_point_equals_jax(rng, kind):
    cj = CAMERAS[kind]
    ct = convert.camera_from_numpy(cj.kind, np.asarray(cj.params), cj.width, cj.height, device="cpu")
    X = points(rng)
    np.testing.assert_allclose(
        tcam.project_point(ct, torch.from_numpy(X)).numpy(),
        np.asarray(jcam.project_point(cj, jnp.asarray(X))), **TOL,
    )
