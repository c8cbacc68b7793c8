"""Package rules of the PyTorch port.

- No module of fasttrack_tpu_torch, and neither of the GPU scripts
  chip_smoke.py and profile_torch.py, imports jax or fasttrack_tpu (the
  JAX package's __init__ imports jax and sets a global matmul precision).
- Importing the port turns TF32 off for matmul and cuDNN (geometry stays
  in full f32, the counterpart of the JAX package's precision pin).
- Nothing on the path is random: the BRIEF pattern and its rotated
  sampling offsets equal the JAX package's.
- The port runs on the card: a constructor given `device=None` goes through
  `device.resolve`, which fails where there is no card; `device="cpu"` is
  honoured. So does `Tracker`, whose tensors then follow its device.
- `nputils.device_fetch` returns what it was given, in one copy.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import fasttrack_tpu_torch
from fasttrack_tpu_torch import cameras, convert, device, geometry, nputils, tracking
from fasttrack_tpu.ops import descriptor as jax_descriptor
from fasttrack_tpu.ops.pattern import PATTERN as JAX_PATTERN
from fasttrack_tpu_torch.ops import descriptor
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.ops.pattern import PATTERN
from fasttrack_tpu_torch.slam_map import Atlas

PACKAGE = Path(fasttrack_tpu_torch.__file__).parent
ROOT = PACKAGE.parent
MODULES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "profile_torch.py"]


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_package_has_the_slice_modules():
    names = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    for m in (
        "geometry/so3.py", "geometry/se3.py", "cameras/models.py", "ops/pattern.py",
        "ops/pyramid.py", "ops/fast.py", "ops/orientation.py", "ops/descriptor.py",
        "ops/hamming.py", "ops/hamming_kernel.py", "ops/extractor.py",
        "ops/stereo_match.py", "ops/project_match.py", "optim/robust.py",
        "optim/pose_opt.py", "frame_pipeline.py", "convert.py",
        "device.py", "cameras/host.py", "fused_track.py", "parity.py", "ops/topk.py",
        "ops/cuda_build.py",
        "nputils.py", "stats.py", "kernels.py", "tracking.py", "slam_map/mappoint.py",
        "slam_map/keyframe.py", "slam_map/map.py", "slam_map/atlas.py",
        "datasets/synthetic.py", "evaluation/ate.py",
    ):
        assert m in names, m
    for source in ("hamming_penalty.cu", "hamming_topk.cu"):
        assert (PACKAGE / "ops" / "csrc" / source).is_file()


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_module_imports_neither_jax_nor_the_jax_package(path):
    assert not imported_roots(path) & {"jax", "jaxlib", "fasttrack_tpu"}


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_brief_pattern_equals_jax():
    np.testing.assert_array_equal(PATTERN, JAX_PATTERN)


def test_sampling_offsets_equal_jax_sampling_matrices():
    mats = jax_descriptor._SAMPLING  # (bins, 512, P*P) one-hot
    assert (mats.sum(-1) == 1).all()
    np.testing.assert_array_equal(descriptor._sampling_indices(), mats.argmax(-1))
    assert (descriptor.N_ANGLE_BINS, descriptor.PATCH_HALF_EXT) == (
        jax_descriptor.N_ANGLE_BINS, jax_descriptor.PATCH_HALF_EXT,
    )


def _store_args(n=4):
    return (np.zeros((n, 3)), np.ones((n, 256), np.int8), np.zeros((n, 3)), np.zeros(n),
            np.full(n, np.inf))


def _keypoint_args(n=4):
    z = np.zeros(n)
    return (z, z, z, z, z, z, z, np.ones((n, 256), np.int8), np.zeros((n, 32), np.uint8), z > 0)


CONSTRUCTORS = {
    "se3_identity": (geometry.se3_identity, ()),
    "make_pinhole": (cameras.make_pinhole, (458.0, 457.0, 367.0, 248.0)),
    "make_kannala_brandt8": (cameras.make_kannala_brandt8, (190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0)),
    "camera_from_numpy": (convert.camera_from_numpy, ("pinhole", np.zeros(8), 752, 480)),
    "se3_from_numpy": (convert.se3_from_numpy, (np.eye(3), np.zeros(3))),
    "map_from_numpy": (convert.map_from_numpy, (
        np.zeros(4), np.zeros(4), np.ones((4, 256), np.int8), np.zeros((4, 3)), np.zeros(4),
        np.zeros(4), np.zeros(4), np.zeros(4, bool))),
    "store_from_numpy": (convert.store_from_numpy, _store_args()),
    "query_block_from_numpy": (convert.query_block_from_numpy, (
        np.zeros((7, 4)), np.zeros(4), np.zeros(6), np.zeros(6, bool))),
    "keypoints_from_numpy": (convert.keypoints_from_numpy, _keypoint_args()),
    "tensor_from_numpy": (convert.tensor_from_numpy, (np.arange(3), np.float32)),
}


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, cameras.Camera):
        return [value.params]
    return [t for v in value for t in _tensors(v)]


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_honours_cpu_and_defaults_to_the_card(name, monkeypatch):
    fn, args = CONSTRUCTORS[name]
    made = _tensors(fn(*args, device="cpu"))
    assert made and all(t.device.type == "cpu" for t in made)
    # device=None goes through the resolver: without a card it raises ...
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(*args)
    # ... and with one it asks for cuda:0 (seen at the resolver: there is no card here)
    asked = []

    def fake_resolve(dev=None):
        asked.append(dev)
        return device.resolve(dev if dev is not None else "cpu")

    for module in (geometry.se3, cameras.models, convert):
        monkeypatch.setattr(module, "resolve", fake_resolve)
    fn(*args)
    assert asked == [None]


def test_resolve():
    assert device.resolve("cpu") == torch.device("cpu")
    assert device.resolve(torch.device("cuda", 1)) == torch.device("cuda", 1)
    if torch.cuda.is_available():
        assert device.resolve() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="found none"):
            device.resolve()


def test_max_dist_of_the_store_is_made_finite():
    st = convert.store_from_numpy(*_store_args(), device="cpu")
    assert (st.max_dist == 1e6).all()
    with pytest.raises(ValueError):
        convert.store_from_numpy(np.zeros((4, 3)), np.ones((3, 256), np.int8), np.zeros((4, 3)),
                                 np.zeros(4), np.zeros(4), device="cpu")


def test_tracker_defaults_to_the_card_and_honours_cpu(monkeypatch):
    cam = cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu")
    cfg = OrbConfig(240, 320, n_features=256, n_levels=4)
    tr = tracking.Tracker(cam, cfg, 28.0, Atlas(), device="cpu")
    assert tr.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in (tr.camera.params, tr._bf_dev, tr._minz_dev))
    assert tr._upload(np.zeros(3), np.float32).device.type == "cpu"
    assert tr.baseline == pytest.approx(28.0 / 256.0)
    assert tr.th_depth == pytest.approx(40 * 28.0 / 256.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tracking.Tracker(cam, cfg, 28.0, Atlas())
    asked = []

    def fake_resolve(dev=None):
        asked.append(dev)
        return torch.device("cpu")

    monkeypatch.setattr(tracking, "resolve", fake_resolve)
    tracking.Tracker(cam, cfg, 28.0, Atlas())
    assert asked == [None]


def test_device_fetch_round_trips_in_argument_order(rng):
    arrays = [rng.normal(size=(3, 5)).astype(np.float32), rng.random(7) > 0.5,
              rng.integers(-9, 9, (2, 2, 3)), rng.integers(0, 255, 11).astype(np.uint8),
              np.float32(2.5)]
    out = nputils.device_fetch(*(torch.from_numpy(np.array(a)) for a in arrays))
    assert len(out) == len(arrays)
    for got, want in zip(out, arrays):
        assert got.dtype == np.asarray(want).dtype and got.shape == np.asarray(want).shape
        np.testing.assert_array_equal(got, want)
    single = nputils.device_fetch(torch.from_numpy(arrays[0].copy()))
    np.testing.assert_array_equal(single, arrays[0])


def test_orthonormalize_has_one_copy(rng):
    from fasttrack_tpu.nputils import orthonormalize as jax_orthonormalize
    from fasttrack_tpu_torch import parity

    assert parity.orthonormalize is nputils.orthonormalize
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0] + 1e-4 * rng.normal(size=(3, 3))
    got = nputils.orthonormalize(R)
    np.testing.assert_array_equal(got, jax_orthonormalize(R))
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-14)
    assert np.linalg.det(got) == pytest.approx(1.0)   # a rotation, even from a reflection
