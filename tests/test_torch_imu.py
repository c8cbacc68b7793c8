"""The port's IMU package against the JAX package's, on the CPU.

- `HostPreintegrated` (the tracker's running accumulation, NumPy float64):
  every field equal to the JAX package's, exactly;
- the device `integrate_measurements` / `preintegrate` (a loop over the
  samples where the JAX package scans): every field within 1e-5, with
  dt == 0 padding rows, a nonzero linearization bias and in two blocks;
  the bias-corrected getters and `predict_state` within 1e-5;
- `pack_preintegrated` equal, `unpack_preintegrated` its inverse;
- `ImuCalib`: noise and walk covariances equal, the card by default;
- the tracker's `_preintegrate_imu`: the frame-boundary cases of
  tests/test_imu.py, and the JAX package's result on a stream with a long
  gap (ROADMAP F5: the zero-order hold has no cap, in both packages);
- `estimate_gyro_bias` and `initialize_imu` on the sequence of
  tests/test_imu_init.py, within 1e-6;
- the whitening factor computed in float64 (the port) against the JAX
  package's, whose float64 cast is float32 without x64 (ROADMAP F9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasttrack_tpu.imu import init as jinit
from fasttrack_tpu.imu import preintegration as jpre
from fasttrack_tpu.optim import inertial as jinertial
from fasttrack_tpu.tracking import Tracker as JaxTracker
from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.imu import init as tinit
from fasttrack_tpu_torch.imu import preintegration as tpre
from fasttrack_tpu_torch.optim import inertial as tinertial
from fasttrack_tpu_torch.tracking import Tracker

FIELDS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C", "avgA", "avgW")
DEVICE_ATOL = 1e-5
JCALIB = jpre.ImuCalib.default(freq=200.0)
TCALIB = tpre.ImuCalib.default(freq=200.0, device="cpu")


def stream(rng, n, dt=1.0 / 200.0, pad=0):
    acc = rng.normal(0, 1, (n + pad, 3)) + [0.0, 0.0, 9.81]
    gyro = rng.normal(0, 0.3, (n + pad, 3))
    dts = np.full(n + pad, dt)
    if pad:
        dts[rng.choice(n + pad, pad, replace=False)] = 0.0   # padding rows anywhere
    return acc.astype(np.float32), gyro.astype(np.float32), dts.astype(np.float32)


def assert_fields_close(got, want, atol, rtol=0.0):
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   atol=atol, rtol=rtol, err_msg=f)
    np.testing.assert_allclose(np.asarray(got.b0.bg), np.asarray(want.b0.bg), atol=atol)
    np.testing.assert_allclose(np.asarray(got.b0.ba), np.asarray(want.b0.ba), atol=atol)


# ------------------------------------------------------------- host accumulation
def test_host_preintegrated_equals_jax_exactly(rng):
    bg, ba = rng.normal(0, 0.01, 3), rng.normal(0, 0.1, 3)
    got, want = tpre.HostPreintegrated(bg, ba), jpre.HostPreintegrated(bg, ba)
    for n in (7, 1, 12):                       # three frames' worth, one of a single sample
        acc, gyro, dts = stream(rng, n)
        dts = dts.astype(np.float64) * rng.uniform(0.9, 1.1, n)
        dts[0] = -1e-3 if n > 1 else dts[0]    # a non-positive step is skipped
        got.integrate(acc, gyro, dts, TCALIB)
        want.integrate(acc, gyro, dts, JCALIB)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    copy = got.copy()
    assert copy.dR is not got.dR and copy.b0.bg is not got.b0.bg
    np.testing.assert_array_equal(copy.C, got.C)


def test_pack_equals_jax_and_unpack_inverts_it(rng):
    p = tpre.HostPreintegrated(rng.normal(0, 0.01, 3), rng.normal(0, 0.1, 3))
    p.integrate(*stream(rng, 10), TCALIB)
    buf = tpre.pack_preintegrated(p)
    assert buf.dtype == np.float32 and buf.shape == (tpre.PRE_PACKED_SIZE,)
    np.testing.assert_array_equal(buf, jpre.pack_preintegrated(p))
    got = tpre.unpack_preintegrated(torch.from_numpy(buf))
    want = jpre.unpack_preintegrated(jnp.asarray(buf))
    assert_fields_close(got, want, atol=0.0)
    assert_fields_close(convert.preintegrated_from_packed(buf, device="cpu"), want, atol=0.0)
    with pytest.raises(ValueError):
        convert.preintegrated_from_packed(buf[:-1], device="cpu")


# ---------------------------------------------------------- device integration
@pytest.mark.parametrize("pad, bias", [(0, False), (9, False), (9, True)],
                         ids=["plain", "dt0-padding", "padding+bias"])
def test_preintegrate_matches_jax(rng, pad, bias):
    acc, gyro, dts = stream(rng, 40, pad=pad)
    b = (rng.normal(0, 0.02, 3).astype(np.float32), rng.normal(0, 0.1, 3).astype(np.float32)) \
        if bias else (np.zeros(3, np.float32), np.zeros(3, np.float32))
    want = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), JCALIB,
                             jpre.ImuBias(jnp.asarray(b[0]), jnp.asarray(b[1])))
    got = tpre.preintegrate(torch.from_numpy(acc), torch.from_numpy(gyro), torch.from_numpy(dts),
                            TCALIB, convert.imu_bias_from_numpy(*b, device="cpu"))
    assert_fields_close(got, want, atol=DEVICE_ATOL, rtol=1e-5)
    assert float(got.dT) == pytest.approx(0.005 * 40, rel=1e-6)


def test_padding_rows_are_no_ops_and_blocks_compose(rng):
    acc, gyro, dts = stream(rng, 32)
    t = [torch.from_numpy(a) for a in (acc, gyro, dts)]
    whole = tpre.preintegrate(*t, TCALIB)
    pre = tpre.Preintegrated.identity(device="cpu")
    pre = tpre.integrate_measurements(pre, t[0][:16], t[1][:16], t[2][:16], TCALIB)
    zeros = torch.zeros(5)
    pre = tpre.integrate_measurements(pre, t[0][:5], t[1][:5], zeros, TCALIB)  # all padding
    pre = tpre.integrate_measurements(pre, t[0][16:], t[1][16:], t[2][16:], TCALIB)
    assert_fields_close(pre, whole, atol=1e-6)
    # and the host accumulation of the same samples, in float64
    host = tpre.HostPreintegrated()
    host.integrate(acc, gyro, dts, TCALIB)
    assert_fields_close(whole, host, atol=DEVICE_ATOL, rtol=1e-4)


def test_getters_and_predict_state_match_jax(rng):
    acc, gyro, dts = stream(rng, 20)
    want_pre = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), JCALIB)
    got_pre = tpre.preintegrate(*(torch.from_numpy(a) for a in (acc, gyro, dts)), TCALIB)
    bg, ba = rng.normal(0, 0.01, 3).astype(np.float32), rng.normal(0, 0.05, 3).astype(np.float32)
    jb, tb = jpre.ImuBias(jnp.asarray(bg), jnp.asarray(ba)), convert.imu_bias_from_numpy(
        bg, ba, device="cpu")
    for jf, tf in ((jpre.delta_rotation, tpre.delta_rotation),
                   (jpre.delta_velocity, tpre.delta_velocity),
                   (jpre.delta_position, tpre.delta_position)):
        np.testing.assert_allclose(tf(got_pre, tb).numpy(), np.asarray(jf(want_pre, jb)),
                                   atol=DEVICE_ATOL)
    R = np.array(jinertial.so3_exp(jnp.asarray([0.3, -0.2, 0.5])), np.float32)
    v, p = rng.normal(0, 1, 3).astype(np.float32), rng.normal(0, 1, 3).astype(np.float32)
    want = jpre.predict_state(jnp.asarray(R), jnp.asarray(v), jnp.asarray(p), want_pre, jb)
    got = tpre.predict_state(*(torch.from_numpy(a) for a in (R, v, p)), got_pre, tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DEVICE_ATOL)


def test_calib_covariances_equal_jax_and_default_to_the_card(monkeypatch):
    np.testing.assert_array_equal(TCALIB.noise_cov().numpy(), np.asarray(JCALIB.noise_cov()))
    np.testing.assert_array_equal(TCALIB.walk_cov().numpy(), np.asarray(JCALIB.walk_cov()))
    assert TCALIB[2:] == JCALIB[2:]
    R, t = TCALIB.extrinsic_np()
    assert R.dtype == np.float64 and (R == np.eye(3)).all() and (t == 0).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tpre.ImuCalib.default(), lambda: tpre.ImuBias.zero(),
                  lambda: tpre.Preintegrated.identity(),
                  lambda: convert.imu_calib_from_numpy(np.eye(3), np.zeros(3), 1, 1, 1, 1, 200)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


# ------------------------------------------------------ the tracker's accumulation
def _stub(cls, calib):
    t = cls.__new__(cls)
    t.imu_queue = []
    t.pre_from_kf = None
    t.pre_from_frame = None
    t.bias = (np.zeros(3), np.zeros(3))
    t.last_imu_time = None
    t._last_preint_ts = None
    t.imu_calib = calib
    return t


def test_jittered_frame_boundaries_cover_the_frame_interval():
    """tests/test_imu.py::TestFrameBoundaryCoverage through the port's
    tracker: sample times jittered by 5e-14 across the frame timestamps."""
    t = _stub(Tracker, TCALIB)
    rng = np.random.default_rng(0)
    ts = np.arange(1, 201) * 0.005 + rng.uniform(-5e-14, 5e-14, 200)
    acc = rng.normal(0, 1, (200, 3))
    gyr = rng.normal(0, 0.1, (200, 3))
    worst = 0.0
    for i in range(1, 20):
        f_ts = i * 0.05
        t.grab_imu([(ts[j], acc[j], gyr[j]) for j in range(200)
                    if (i - 1) * 0.05 < ts[j] + 2.5e-3 and ts[j] - 2.5e-3 <= f_ts])
        t.imu_queue = [s for s in t.imu_queue if s[0] > ((i - 1) * 0.05)]
        t._preintegrate_imu(f_ts)
        if i > 1:
            worst = max(worst, abs(float(t.pre_from_frame.dT) - 0.05))
    assert worst < 1e-8, worst
    # exact (ns-quantized) boundaries grow no fill step
    t = _stub(Tracker, TCALIB)
    ts = np.arange(1, 41) * 0.005
    for i in range(1, 4):
        f_ts = i * 0.05
        t.grab_imu([(x, np.zeros(3), np.zeros(3)) for x in ts if (i - 1) * 0.05 < x <= f_ts])
        t._preintegrate_imu(f_ts)
        if i > 1:
            assert abs(float(t.pre_from_frame.dT) - 0.05) < 1e-12


def test_gap_fill_has_no_cap_as_in_jax():
    """ROADMAP F5, kept for parity: after a 1.5 s gap in the stream the
    zero-order hold carries the last sample across the whole gap, in both
    packages; the frame-to-frame and since-keyframe accumulations equal the
    JAX package's exactly."""
    rng = np.random.default_rng(3)
    got, want = _stub(Tracker, TCALIB), _stub(JaxTracker, JCALIB)
    samples = [(0.005 * k, rng.normal(0, 1, 3), rng.normal(0, 0.1, 3)) for k in range(1, 11)]
    for tr in (got, want):
        tr.grab_imu(samples)
        tr._preintegrate_imu(0.05)
        tr.grab_imu([(0.055, samples[-1][1], samples[-1][2])])
        tr._preintegrate_imu(1.6)          # one sample, then a 1.545 s hold
    assert got.pre_from_frame.dT == pytest.approx(1.55, abs=1e-12)
    for a, b in ((got.pre_from_frame, want.pre_from_frame), (got.pre_from_kf, want.pre_from_kf)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert got.last_imu_time == want.last_imu_time == 1.6


# ------------------------------------------------------------------- IMU init
@pytest.fixture(scope="module")
def init_data():
    """tests/test_imu_init.py's keyframes: every 4th frame of a 40-frame
    sequence, preintegrated between them (host accumulation, no bias)."""
    seq = synthetic.generate_sequence(n_frames=40, h=32, w=32, fps=20.0, imu_rate=200.0, seed=1)
    idx = list(range(0, len(seq.frames), 4))
    R_wb = [seq.frames[i].R_wc for i in idx]
    p_w = [seq.frames[i].t_wc for i in idx]
    times = [seq.frames[i].timestamp for i in idx]
    preints = []
    for a, b in zip(times[:-1], times[1:]):
        m = (seq.imu_t > a) & (seq.imu_t <= b)
        p = tpre.HostPreintegrated()
        p.integrate(seq.imu_acc[m], seq.imu_gyro[m] + [0.02, -0.015, 0.01],
                    np.full(m.sum(), 1.0 / 200.0), TCALIB)
        preints.append(p)
    return R_wb, p_w, preints


def test_gyro_bias_equals_jax(init_data):
    R_wb, _, preints = init_data
    got = tinit.estimate_gyro_bias(R_wb, preints)
    np.testing.assert_allclose(got, jinit.estimate_gyro_bias(R_wb, preints), atol=1e-6)
    np.testing.assert_allclose(got, [0.02, -0.015, 0.01], atol=4e-3)   # the injected bias


@pytest.mark.parametrize("kw", [dict(), dict(estimate_ba=False), dict(mono_scale=True)],
                         ids=["with-ba", "ba-pinned", "mono-scale"])
def test_initialize_imu_equals_jax(init_data, kw):
    R_wb, p_w, preints = init_data
    got = tinit.initialize_imu(R_wb, p_w, preints, **kw)
    want = jinit.initialize_imu(R_wb, p_w, preints, **kw)
    assert got.success == want.success is True
    for f in ("bg", "gravity_w", "velocities", "R_gw", "ba"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), atol=1e-6, err_msg=f)
    assert got.scale == pytest.approx(want.scale, abs=1e-6)
    np.testing.assert_allclose(got.gravity_w, [0, 0, -tpre.GRAVITY_VALUE], atol=0.3)
    # too few keyframes: the JAX package's failure value
    short = tinit.initialize_imu(R_wb[:2], p_w[:2], preints[:1])
    assert not short.success and short.velocities.shape == (2, 3)


# ------------------------------------------------------------ F9: the whitening
def _cov(dt_steps, rng):
    p = tpre.HostPreintegrated()
    p.integrate(*stream(rng, dt_steps), TCALIB)
    return p.C


def test_whitening_in_float64_against_the_jax_float32_factors():
    """ROADMAP F9. The JAX package computes W = C^-1/2 with a float64 cast
    that x64-less JAX runs in float32; the port computes it in float64.
    On a frame's covariance (10 samples at 200 Hz, condition ~5e3) the two
    factors agree to 2e-4 relative (measured 7e-5), and the float64 one
    whitens to 1e-9 (W C W = I; float32: 1.5e-4). On a 3-sample interval
    (smallest eigenvalue ~1e-12, condition ~6e4: near-singular for float32)
    they part by more than 3e-4 relative (measured 7e-4), and float32
    whitens only to 1.4e-3 where float64 stays 10x closer (5.6e-5).
    Shorter intervals fall under both packages' 1e-12 eigenvalue floor."""
    out = {}
    for n in (10, 3):
        C9 = _cov(n, np.random.default_rng(n))[:9, :9]
        got = tinertial._info_sqrt(C9)
        want = np.asarray(jinertial._info_sqrt(jnp.asarray(C9, jnp.float32)), np.float64)
        out[n] = (np.abs(got - want).max() / np.abs(got).max(),
                  np.abs(got @ C9 @ got - np.eye(9)).max(),
                  np.abs(want @ C9 @ want - np.eye(9)).max())
    rel, err64, err32 = out[10]
    assert rel < 2e-4 and err64 < 1e-9, out
    rel, err64, err32 = out[3]
    assert rel > 3e-4 and err32 > 1e-3 and err64 < 0.1 * err32, out
    # the packed factors of a whole covariance: W9, Wbg, Wba in that order
    C = _cov(10, np.random.default_rng(1))
    W = tinertial.whitening_np(C)
    assert W.shape == (tinertial.WHITEN_SIZE,)
    np.testing.assert_allclose(W[81:90].reshape(3, 3), tinertial._info_sqrt(C[9:12, 9:12]))
    H = np.diag(np.random.default_rng(2).uniform(1, 1e6, 15))
    np.testing.assert_allclose(tinertial.sqrtm_psd_np(H) @ tinertial.sqrtm_psd_np(H), H,
                               rtol=1e-10)
