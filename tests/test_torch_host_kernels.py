"""The port's host kernels (the CPU sides of the offload toggles) against the
JAX package's, on the CPU.

Frames of `generate_sequence(n_frames=14, h=240, w=320, seed=3)` and random
packed descriptors made with numpy go through `fasttrack_tpu.ops.host_kernels`
and `fasttrack_tpu_torch.ops.host_kernels`. Both are NumPy over the same C++
source, so every comparison is exact: the pyramids, every field of the
extracted keypoints, the stereo depths, and the matchers' indices, distances
and masks. Also held here:

- the port's native library: its three entry points equal the JAX
  package's, each side running its own build of its own source (the JAX
  package's `native/fasttrack_native.cpp` is compiled here into a temporary
  directory, see `jax_native_library`); the port's is built into
  `fasttrack_tpu_torch/_build/`, never under `native/`; a failed g++ build
  raises with g++'s messages;
- ROADMAP F1, mirrored per toggle: the host extractor takes the IC angle
  from the raw pyramid and the device extractor from the blurred one. The
  port's host angles equal the JAX host angles exactly, its device angles
  equal the JAX device angles on co-detected keypoints within 1e-4 rad (the
  extraction tests' keypoint overlap, then f32 sums in another order), and
  host and device angles of co-detected keypoints differ.
"""

import contextlib
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasttrack_tpu import native as jnative
from fasttrack_tpu.ops import host_kernels as jhk
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked as jax_extract
from fasttrack_tpu_torch import native as tnative
from fasttrack_tpu_torch import parity
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.ops import host_kernels as thk
from fasttrack_tpu_torch.ops.extractor import OrbConfig, extract_orb_pair_stacked

H, W = 240, 320
JCFG = JaxOrbConfig(H, W, n_features=512, n_levels=4)
CFG = OrbConfig(**JCFG._asdict())
ROOT = os.path.join(os.path.dirname(__file__), "..")


def build_jax_native(out_dir) -> str:
    """The JAX package's own `native/fasttrack_native.cpp`, compiled with
    `native/Makefile`'s flags into `out_dir`; returns the library's path.
    It reads `native/` and writes nothing there."""
    out = os.path.join(str(out_dir), "libfasttrack_native.so")
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-o", out,
                    os.path.join(ROOT, "native", "fasttrack_native.cpp")],
                   check=True, capture_output=True)
    return out


@contextlib.contextmanager
def jax_native_library(out_dir):
    """For the block, the JAX package's native module loads its own C++
    source, freshly built into `out_dir`. Left alone, it runs `make` in
    `native/` at its first call when the library is missing, with no lock,
    and under xdist another worker can load the half-written file (ROADMAP,
    the tier-1 count). A private build of the same file avoids that race and
    keeps the JAX side an independent oracle: the port's C++ is its own copy,
    built into `fasttrack_tpu_torch/_build/`, and each side loads its own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_SO", build_jax_native(out_dir))
    mp.setattr(jnative, "_lib", None)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module", autouse=True)
def jax_own_native(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=14, h=H, w=W, seed=3)


def _scales(cfg):
    return np.asarray([cfg.scale_factor**l for l in range(cfg.n_levels)], np.float32)


def _packed(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def _noisy_copies(rng, packed, pick, n_flip):
    out = packed[pick].copy()
    for row in out:
        bits = rng.choice(256, n_flip, replace=False)
        row[bits // 8] ^= (1 << (bits % 8)).astype(np.uint8)
    return out


def _search_case(rng, m=300, n=400):
    """n keypoints and m projected queries around them, most a noisy copy of
    the descriptor of the keypoint they came from."""
    kp_uv = rng.uniform(0, [W, H], (n, 2)).astype(np.float32)
    kp_packed = _packed(rng, n)
    kp_level = rng.integers(0, 4, n).astype(np.int32)
    kp_valid = rng.random(n) > 0.1
    pick = rng.integers(0, n, m)
    q_uv = (kp_uv[pick] + rng.normal(0, 3, (m, 2))).astype(np.float32)
    q_packed = _noisy_copies(rng, kp_packed, pick, 20)
    q_packed[::5] = _packed(rng, len(q_packed[::5]))
    lvl = kp_level[pick]
    q_radius = (7.0 * 1.2 ** lvl).astype(np.float32)
    q_lmin = np.maximum(lvl - 1, 0).astype(np.int32)
    q_lmax = np.minimum(lvl + 1, 3).astype(np.int32)
    q_valid = rng.random(m) > 0.1
    return (q_uv, q_packed, q_radius, q_lmin, q_lmax, q_valid,
            kp_uv, kp_packed, kp_level, kp_valid)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ native library
def test_native_hamming_equals_jax(rng):
    a, b = _packed(rng, 70), _packed(rng, 45)
    got = tnative.hamming_matrix_packed(a, b)
    _assert_same([got], [jnative.hamming_matrix_packed(a, b)])
    assert jnative._lib._name == jnative._SO != str(tnative.library_path())  # two libraries
    bits = lambda p: np.unpackbits(p, axis=1).astype(np.int32)
    np.testing.assert_array_equal(got, (bits(a)[:, None] != bits(b)[None]).sum(-1))


def test_native_fast_score_equals_jax(seq):
    img = seq.frames[0].left.astype(np.float32)
    got = tnative.fast_score(img)
    _assert_same([got], [jnative.fast_score(img)])
    assert (got > 7).sum() > 100


def test_native_distribute_octree_equals_jax(rng):
    x = rng.uniform(0, 640, 900).astype(np.float32)
    y = rng.uniform(0, 480, 900).astype(np.float32)
    s = rng.uniform(0, 100, 900).astype(np.float32)
    for target in (1, 37, 100, 2000):
        got = tnative.distribute_octree(x, y, s, (0, 640, 0, 480), target)
        _assert_same([got], [jnative.distribute_octree(x, y, s, (0, 640, 0, 480), target)])
        assert 0 < len(got) <= target and len(np.unique(got)) == len(got)


def test_native_entry_points_reject_what_the_library_would_read_past(rng):
    with pytest.raises(ValueError, match="32"):
        tnative.hamming_matrix_packed(_packed(rng, 3)[:, :16], _packed(rng, 2))
    with pytest.raises(ValueError, match="image"):
        tnative.fast_score(np.zeros((2, 8, 8), np.float32))
    with pytest.raises(ValueError, match="one length"):
        tnative.distribute_octree(np.zeros(4), np.zeros(3), np.zeros(4), (0, 8, 0, 8), 2)
    assert len(tnative.distribute_octree(np.zeros(4), np.zeros(4), np.ones(4), (0, 8, 0, 8), 0)) == 0


def test_native_build_stays_in_the_port_and_never_writes_under_native(tmp_path, monkeypatch):
    native_dir = os.path.join(ROOT, "native")
    before = {p: os.stat(os.path.join(native_dir, p)).st_mtime_ns for p in os.listdir(native_dir)}
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.name == "_build" and tnative.BUILD_DIR.parent.name == "fasttrack_tpu_torch"
    assert tnative.SOURCE.parent.name == "csrc"
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    out = tnative.build()
    assert out.parent == tmp_path / "_build" and out.is_file()
    assert not [p for p in out.parent.iterdir() if p.suffix == ".tmp"]
    after = {p: os.stat(os.path.join(native_dir, p)).st_mtime_ns for p in os.listdir(native_dir)}
    assert after == before


def test_native_build_failure_raises_with_the_compilers_messages(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int f() { return undeclared_name; }\n')
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed on broken.cpp.*undeclared_name"):
        tnative.build()
    assert not list((tmp_path / "_build").iterdir())


# ---------------------------------------------------------------- extraction
@pytest.mark.parametrize("i", [0, 13])
def test_host_build_pyramid_equals_jax(seq, i):
    img = seq.frames[i].left
    got = thk.host_build_pyramid(img, CFG.pyramid)
    _assert_same(got, jhk.host_build_pyramid(img, JCFG.pyramid))
    assert got[0].shape == (4, H, W)


@pytest.mark.parametrize("i, side", [(0, "left"), (6, "right"), (13, "left")])
def test_host_extract_orb_with_pyramid_equals_jax(seq, i, side):
    img = getattr(seq.frames[i], side)
    (kt, raw_t, blur_t), (kj, raw_j, blur_j) = (
        thk.host_extract_orb_with_pyramid(img, CFG), jhk.host_extract_orb_with_pyramid(img, JCFG))
    assert kt._fields == kj._fields
    _assert_same(kt, kj)
    _assert_same((raw_t, blur_t), (raw_j, blur_j))
    assert kt.valid.sum() > 300
    _assert_same(thk.host_extract_orb(img, CFG), kt)


@pytest.mark.parametrize("i", [0, 13])
def test_host_match_rectified_equals_jax(seq, i):
    f = seq.frames[i]
    kl, raw_l, _ = thk.host_extract_orb_with_pyramid(f.left, CFG)
    kr, raw_r, _ = thk.host_extract_orb_with_pyramid(f.right, CFG)
    bf = seq.fx * seq.baseline
    got = thk.host_match_rectified(kl, kr, raw_l, raw_r, _scales(CFG), bf, seq.baseline)
    _assert_same(got, jhk.host_match_rectified(kl, kr, raw_l, raw_r, _scales(CFG), bf,
                                                seq.baseline))
    depth = got[1][got[1] > 0]
    assert len(depth) > 150 and 2.0 < np.median(depth) < 8.0


# ------------------------------------------------------------------ matchers
@pytest.mark.parametrize("ratio, taken", [(None, False), (0.8, False), (None, True), (0.8, True)],
                         ids=["plain", "ratio", "taken", "ratio_taken"])
def test_host_search_by_projection_equals_jax(rng, ratio, taken):
    case = _search_case(rng)
    kp_taken = rng.random(len(case[6])) < 0.25 if taken else None
    got = thk.host_search_by_projection(*case, kp_taken=kp_taken, ratio=ratio)
    _assert_same(got, jhk.host_search_by_projection(*case, kp_taken=kp_taken, ratio=ratio))
    idx, dist, ok = got
    assert 50 < ok.sum() < len(ok)
    assert (dist[~ok] > 100).any() or ratio is not None
    if taken:
        assert not kp_taken[idx[ok]].any()


def test_host_twm_match_equals_jax(rng):
    case = _search_case(rng)
    q_angle = rng.uniform(0, 2 * np.pi, len(case[0])).astype(np.float32)
    kp_angle = (np.full(len(case[6]), 0.3, np.float32)
                + rng.normal(0, 0.05, len(case[6])).astype(np.float32))
    got = thk.host_twm_match(*case, q_angle, kp_angle)
    _assert_same(got, jhk.host_twm_match(*case, q_angle, kp_angle))
    idx, keep = got
    assert keep.sum() > 20
    assert len(np.unique(idx[keep])) == keep.sum()     # one query per keypoint


def test_host_tlm_match_equals_jax(rng):
    case = _search_case(rng)
    kp_taken = rng.random(len(case[6])) < 0.25
    got = thk.host_tlm_match(*case, kp_taken)
    _assert_same(got, jhk.host_tlm_match(*case, kp_taken))
    idx, keep = got
    assert keep.sum() > 20 and not kp_taken[idx[keep]].any()
    assert len(np.unique(idx[keep])) == keep.sum()


def test_resolve_duplicates_equals_jax(rng):
    idx = rng.integers(0, 30, 200).astype(np.int32)
    dist = rng.integers(0, 60, 200).astype(np.int32)   # many ties: the first query wins
    ok = rng.random(200) > 0.3
    got = thk._resolve_duplicates(idx, dist, ok, 30)
    _assert_same([got], [jhk._resolve_duplicates(idx, dist, ok, 30)])
    assert got.dtype == bool and len(np.unique(idx[got])) == got.sum()


# ------------------------------------------------------- ROADMAP F1, pinned
def test_ic_angle_is_mirrored_per_toggle(seq):
    f = seq.frames[0]
    host_t = thk.host_extract_orb(f.left, CFG)
    host_j = jhk.host_extract_orb(f.left, JCFG)
    np.testing.assert_array_equal(host_t.angle, host_j.angle)     # raw pyramid, both

    stacked = np.stack([f.left, f.right]).astype(np.float32)
    dev_t = extract_orb_pair_stacked(torch.from_numpy(stacked), CFG)[0]
    dev_j = jax_extract(jnp.asarray(stacked), JCFG)[0]

    def as_dict(k):
        return {name: np.asarray(getattr(k, name) if not isinstance(getattr(k, name), torch.Tensor)
                                 else getattr(k, name).numpy())
                for name in ("x", "y", "level", "angle", "valid")}

    a, b = as_dict(dev_j), as_dict(dev_t)
    assert parity.keypoint_overlap(a, b) >= parity.MIN_KP_OVERLAP
    ia, ib = parity.codetected(a, b)
    d = np.angle(np.exp(1j * (a["angle"][ia] - b["angle"][ib])))
    assert len(ia) > 300 and np.abs(d).max() < 1e-4               # blurred pyramid, both

    h = {name: getattr(host_t, name) for name in ("x", "y", "level", "angle", "valid")}
    ih, idev = parity.codetected(h, b)
    assert len(ih) > 50
    dh = np.abs(np.angle(np.exp(1j * (h["angle"][ih] - b["angle"][idev]))))
    # same keypoint, other pyramid: the angles part (median 0.014 rad here;
    # the two extractions agree to 1e-4 where they read the same pyramid)
    assert np.median(dh) > 5e-3 and (dh > 1e-3).mean() > 0.9
