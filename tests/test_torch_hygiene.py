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
  honoured.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import fasttrack_tpu_torch
from fasttrack_tpu_torch import cameras, convert, device, geometry
from fasttrack_tpu.ops import descriptor as jax_descriptor
from fasttrack_tpu.ops.pattern import PATTERN as JAX_PATTERN
from fasttrack_tpu_torch.ops import descriptor
from fasttrack_tpu_torch.ops.pattern import PATTERN

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
