"""Package rules of the PyTorch port.

- No module of fasttrack_tpu_torch, neither of the GPU scripts
  chip_smoke.py and profile_torch.py, and not the port's example script
  examples/torch_stereo_euroc.py, imports jax or fasttrack_tpu (the JAX
  package's __init__ imports jax and sets a global matmul precision).
- Importing the port turns TF32 off for matmul and cuDNN (geometry stays
  in full f32, the counterpart of the JAX package's precision pin).
- Nothing on the path is random: the BRIEF pattern and its rotated
  sampling offsets equal the JAX package's.
- The port runs on the card: a constructor given `device=None` goes through
  `device.resolve`, which fails where there is no card; `device="cpu"` is
  honoured (the KB8 camera, the stereo rigs and the rectified camera
  included). So do `Tracker`, `LocalMapper`, `System` and the bundle
  adjustment's window assembly, whose tensors then follow their device;
  and, with an IMU, `ImuCalib`, `Tracker`, `LocalMapper` and
  `System(Sensor.IMU_STEREO)`.
- `nputils.device_fetch` returns what it was given, in one copy.
- The System given a distorted pinhole pair to rectify and a size to
  resize to, and given a KB8 pair, does the same; no NotImplementedError
  of the port names resize, rectification or KB8 any more.
- Place recognition: the vocabulary is the port's own copy, loaded from its
  own directory; `LoopCloser`, the default `System` (which builds one) and
  the functions that run on a device (`quantize` of a flat vocabulary,
  `train_vocabulary`, `optimize_sim3`) resolve `device=None` to the card.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import fasttrack_tpu_torch
from fasttrack_tpu_torch import (
    ba_assembly,
    cameras,
    convert,
    device,
    geometry,
    local_mapping,
    nputils,
    system,
    tracking,
)
from fasttrack_tpu_torch.cameras import rectify, stereo
from fasttrack_tpu_torch.imu import preintegration as tpre
from fasttrack_tpu.ops import descriptor as jax_descriptor
from fasttrack_tpu.ops.pattern import PATTERN as JAX_PATTERN
from fasttrack_tpu_torch.ops import descriptor
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.ops.pattern import PATTERN
from fasttrack_tpu_torch.slam_map import Atlas

PACKAGE = Path(fasttrack_tpu_torch.__file__).parent
ROOT = PACKAGE.parent
MODULES = sorted(PACKAGE.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_torch.py",
    ROOT / "examples" / "torch_stereo_euroc.py", ROOT / "examples" / "torch_stereo_tumvi.py",
]


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
        "geometry/so3.py", "geometry/se3.py", "geometry/sim3.py", "cameras/models.py", "ops/pattern.py",
        "ops/pyramid.py", "ops/fast.py", "ops/orientation.py", "ops/descriptor.py",
        "ops/hamming.py", "ops/hamming_kernel.py", "ops/extractor.py",
        "ops/stereo_match.py", "ops/project_match.py", "optim/robust.py",
        "optim/pose_opt.py", "frame_pipeline.py", "convert.py",
        "device.py", "cameras/host.py", "fused_track.py", "parity.py", "ops/topk.py",
        "ops/cuda_build.py",
        "nputils.py", "stats.py", "kernels.py", "tracking.py", "slam_map/mappoint.py",
        "slam_map/keyframe.py", "slam_map/map.py", "slam_map/atlas.py",
        "datasets/synthetic.py", "evaluation/ate.py",
        "cameras/stereo.py", "optim/ba_core.py", "optim/local_ba.py", "ba_assembly.py",
        "ops/host_kernels.py", "local_mapping.py", "settings.py", "datasets/loaders.py",
        "system.py", "imu/__init__.py", "imu/preintegration.py", "imu/init.py",
        "optim/inertial.py", "native.py",
        "bow/__init__.py", "bow/vocabulary.py", "bow/database.py", "optim/pnp.py",
        "optim/sim3_solver.py", "optim/sim3_opt.py", "optim/pose_graph.py", "loop_closing.py",
        "cameras/rectify.py",
    ):
        assert m in names, m
    for source in ("hamming_penalty.cu", "hamming_topk.cu", "fasttrack_native.cpp"):
        assert (PACKAGE / "ops" / "csrc" / source).is_file()
    for data in ("orb_vocab_32k.npz", "orb_vocab.npz"):
        assert (PACKAGE / "bow" / data).is_file()


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
    "sim3_identity": (geometry.sim3_identity, ()),
    "make_pinhole": (cameras.make_pinhole, (458.0, 457.0, 367.0, 248.0)),
    "make_kannala_brandt8": (cameras.make_kannala_brandt8, (190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0)),
    "stereo_rig_from_numpy": (stereo.stereo_rig_from_numpy, (
        cameras.make_kannala_brandt8(190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0, device="cpu"),
        cameras.make_kannala_brandt8(190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0, device="cpu"),
        np.eye(4), 19.0)),
    "make_rectified_rig": (stereo.make_rectified_rig, (
        cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu"), 28.0)),
    "compute_rectification": (rectify.compute_rectification, (
        cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu"),
        np.array([-0.28, 0.07, 1e-4, 0.0]),
        cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu"),
        np.zeros(4), np.diag([1.0, 1.0, 1.0, 1.0]) + np.eye(4, k=3) * 0.11, 32, 24)),
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
    "imu_calib_from_numpy": (convert.imu_calib_from_numpy, (
        np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)),
    "imu_bias_from_numpy": (convert.imu_bias_from_numpy, (np.zeros(3), np.zeros(3))),
    "preintegrated_from_packed": (convert.preintegrated_from_packed, (
        np.zeros(tpre.PRE_PACKED_SIZE),)),
    "preintegrated_from_numpy": (convert.preintegrated_from_numpy, (tpre.HostPreintegrated(),)),
    "body_state_from_numpy": (convert.body_state_from_numpy, (
        np.eye(3), np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3))),
    "ImuCalib.default": (tpre.ImuCalib.default, (200.0,)),
    "ba_problem_from_numpy": (convert.ba_problem_from_numpy, ({
        "R": np.tile(np.eye(3), (2, 1, 1)), "t": np.zeros((2, 3)), "points": np.zeros((4, 3)),
        "obs_uv": np.zeros((4, 2, 2)), "obs_ur": np.zeros((4, 2)),
        "inv_sigma2": np.ones((4, 2)), "mask": np.zeros((4, 2), bool),
        "cam_free": np.ones(2, bool), "point_free": np.ones(4, bool)},)),
}


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, cameras.Camera):
        return [value.params]
    if isinstance(value, rectify.RectifyMaps):
        return [value.camera.params]
    if not isinstance(value, tuple):
        return []                       # the noise densities of an ImuCalib
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

    for module in (geometry.se3, geometry.sim3, cameras.models, stereo, convert, tpre):
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


def _asks_the_resolver(monkeypatch, modules, build):
    """`build()` without a device: raises where there is no card, and asks
    the resolver of each of `modules` for the card (None), never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
    asked = []

    def fake_resolve(dev=None):
        asked.append(dev)
        return torch.device("cpu") if dev is None else torch.device(dev)

    for module in modules:
        monkeypatch.setattr(module, "resolve", fake_resolve)
    made = build()
    assert asked and asked[0] is None
    return made


def test_local_mapper_defaults_to_the_card_and_honours_cpu(monkeypatch):
    cam = cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu")
    lm = local_mapping.LocalMapper(Atlas(), cam, 28.0, 1.2, 4, device="cpu")
    assert lm.device == torch.device("cpu")
    assert lm.camera.params.device.type == "cpu" and lm._bf_dev.device.type == "cpu"
    assert lm._cam_host.params.dtype == np.float64
    _asks_the_resolver(monkeypatch, [local_mapping],
                       lambda: local_mapping.LocalMapper(Atlas(), cam, 28.0, 1.2, 4))


def test_system_defaults_to_the_card_and_honours_cpu(monkeypatch):
    from fasttrack_tpu_torch.settings import Settings

    cam = cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu")

    def settings():
        return Settings(camera1=cam, bf=28.0, width=320, height=240, n_features=256, n_levels=4)

    s = system.System(settings(), vocabulary=False, device="cpu")
    assert s.device == s.tracker.device == s.local_mapper.device == torch.device("cpu")
    made = _asks_the_resolver(monkeypatch, [system],
                              lambda: system.System(settings(), vocabulary=False))
    # the system hands the device it resolved to its tracker and its mapper
    assert made.tracker.device == made.local_mapper.device == made.device


def test_window_assembly_defaults_to_the_card_and_honours_cpu(monkeypatch):
    m = Atlas().current
    inv_sigma2 = np.ones(4)
    prob, meta, dropped = ba_assembly.assemble_window(m, [], [], inv_sigma2, 2, 8, device="cpu")
    assert prob.points.device.type == "cpu" and prob.mask.shape == (8, 2) and dropped == 0
    # the mapper's windows are solved in float64 (ba_assembly says why)
    assert prob.points.dtype == prob.poses.R.dtype == prob.obs_uv.dtype == torch.float64
    assert meta.mp_ids == [] and not prob.mask.any()
    _asks_the_resolver(monkeypatch, [convert],
                       lambda: ba_assembly.assemble_window(m, [], [], inv_sigma2, 2, 8))
    cam = cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu")
    _asks_the_resolver(monkeypatch, [ba_assembly, convert],
                       lambda: ba_assembly.solve_window(m, [], [], cam, 28.0, inv_sigma2, 2, 8))


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


def test_the_inertial_system_defaults_to_the_card_and_honours_cpu(monkeypatch):
    from fasttrack_tpu_torch.settings import Settings

    cam = cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu")
    cfg = OrbConfig(240, 320, n_features=256, n_levels=4)
    calib = tpre.ImuCalib.default(device="cpu")
    tr = tracking.Tracker(cam, cfg, 28.0, Atlas(), imu_calib=calib, device="cpu")
    lm = local_mapping.LocalMapper(Atlas(), cam, 28.0, imu_calib=calib, device="cpu")
    for dev in (tr._Rbc_dev, tr._tbc_dev, lm._Rbc_dev, lm._tbc_dev):
        assert dev.device.type == "cpu"
    assert tr._R_bc.dtype == lm._R_bc.dtype == np.float64

    def settings():
        return Settings(camera1=cam, bf=28.0, width=320, height=240, n_features=256, n_levels=4)

    s = system.System(settings(), system.Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    assert s.imu_calib.R_bc.device.type == "cpu" and s.tracker.use_imu
    made = _asks_the_resolver(monkeypatch, [system, tracking, local_mapping, convert], lambda: (
        system.System(settings(), system.Sensor.IMU_STEREO, vocabulary=False)))
    assert made.imu_calib.R_bc.device == made.tracker._Rbc_dev.device == made.device
    monkeypatch.undo()
    _asks_the_resolver(monkeypatch, [tracking], lambda: tracking.Tracker(
        cam, cfg, 28.0, Atlas(), imu_calib=calib))
    monkeypatch.undo()
    _asks_the_resolver(monkeypatch, [local_mapping], lambda: local_mapping.LocalMapper(
        Atlas(), cam, 28.0, imu_calib=calib))


def test_the_vocabulary_is_the_ports_own():
    from fasttrack_tpu_torch.bow import vocabulary

    for path in (vocabulary.DEFAULT_TREE, vocabulary.DEFAULT_FLAT):
        assert Path(path).resolve().parent == (PACKAGE / "bow").resolve()
    source = (PACKAGE / "bow" / "vocabulary.py").read_text()
    assert "fasttrack_tpu/" not in source.replace("fasttrack_tpu/bow/vocabulary.py", "")


def test_place_recognition_defaults_to_the_card_and_honours_cpu(monkeypatch):
    from fasttrack_tpu_torch import loop_closing
    from fasttrack_tpu_torch.bow import vocabulary
    from fasttrack_tpu_torch.optim import sim3_opt
    from fasttrack_tpu_torch.settings import Settings

    cam = cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device="cpu")
    K = np.array([[256.0, 0, 160.0], [0, 256.0, 120.0], [0, 0, 1]])
    voc = vocabulary.make_random_vocabulary(16)
    lc = loop_closing.LoopCloser(Atlas(), voc, K, camera=cam, device="cpu")
    assert lc.device == torch.device("cpu") and lc.camera.params.device.type == "cpu"
    made = _asks_the_resolver(monkeypatch, [loop_closing],
                              lambda: loop_closing.LoopCloser(Atlas(), voc, K, camera=cam))
    assert made.camera.params.device == made.device
    monkeypatch.undo()

    def settings():
        return Settings(camera1=cam, bf=28.0, width=320, height=240, n_features=256, n_levels=4)

    made = _asks_the_resolver(monkeypatch, [system], lambda: system.System(settings()))
    assert made.loop_closer.device == made.tracker.device == made.device
    monkeypatch.undo()
    # the stereo-inertial system with its loop closer on threads of its own
    made = _asks_the_resolver(monkeypatch, [system], lambda: system.System(
        settings(), system.Sensor.IMU_STEREO, async_mapping=True))
    made.shutdown()
    assert made.loop_closer.device == made.local_mapper.device == made.device
    assert not made.loop_closer._thread.is_alive() and not made.local_mapper._thread.is_alive()
    monkeypatch.undo()
    descs = np.ones((20, 256), np.int8)
    for build in (lambda: vocabulary.quantize(voc, descs),
                  lambda: vocabulary.train_vocabulary(descs, 4),
                  lambda: sim3_opt.optimize_sim3(np.ones((4, 3)), np.ones((4, 3)), np.zeros((4, 2)),
                                                 np.zeros((4, 2)), K, K, np.ones(4), np.ones(4),
                                                 1.0, np.eye(3), np.zeros(3))):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
        monkeypatch.undo()


def _rig_settings(kind, device):
    from fasttrack_tpu_torch.settings import Settings

    T = np.eye(4)
    T[0, 3] = 0.11
    if kind == "kb8":
        make = lambda: cameras.make_kannala_brandt8(190.0, 190.0, 160.0, 120.0, 0.003, 0.0007,
                                                    -0.002, 0.0002, 320, 240, device=device)
        return Settings(camera_type="KannalaBrandt8", camera1=make(), camera2=make(), T_c1_c2=T,
                        bf=19.0, width=320, height=240, n_features=256, n_levels=4)
    make = lambda: cameras.make_pinhole(256.0, 256.0, 160.0, 120.0, 320, 240, device=device)
    return Settings(camera1=make(), camera2=make(), dist1=np.array([-0.28, 0.07, 1e-4, 0.0]),
                    dist2=np.zeros(4), T_c1_c2=T, bf=28.0, width=320, height=240,
                    new_width=160, new_height=120, n_features=256, n_levels=4)


@pytest.mark.parametrize("kind", ["rectified-resized", "kb8"])
def test_the_rig_systems_default_to_the_card_and_honour_cpu(monkeypatch, kind):
    s = system.System(_rig_settings(kind, "cpu"), system.Sensor.IMU_STEREO, vocabulary=False,
                      device="cpu")
    if kind == "kb8":
        rig = s.tracker.stereo_rig
        assert rig is not None and s._rect is None
        assert all(t.device.type == "cpu" for t in (rig.left.params, rig.right.params,
                                                    rig.T_rl.R, rig.bf))
    else:
        assert s._rect is not None and s._rect.camera.params.device.type == "cpu"
        assert s.tracker.cfg.width == 160 and s.tracker.camera.params.device.type == "cpu"
    made = _asks_the_resolver(monkeypatch, [system], lambda: system.System(
        _rig_settings(kind, "cpu"), system.Sensor.IMU_STEREO, vocabulary=False))
    assert made.tracker.device == made.device
    if kind == "kb8":
        assert made.tracker.stereo_rig.left.params.device == made.device
    else:
        assert made._rect.camera.params.device == made.device


def test_no_not_implemented_error_names_resize_rectification_or_kb8():
    for path in PACKAGE.rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if "NotImplementedError" in line:
                low = line.lower()
                for word in ("resize", "rectif", "kb8", "fisheye", "kannala", "newwidth"):
                    assert word not in low, f"{path.relative_to(ROOT)}:{n}: {line.strip()}"
    # the sensors and parts still to port keep their raise
    with pytest.raises(NotImplementedError, match="M9"):
        system.System(_rig_settings("kb8", "cpu"), system.Sensor.MONOCULAR, device="cpu")
    atlas = _rig_settings("kb8", "cpu")
    atlas.load_atlas = "in.osa"
    with pytest.raises(NotImplementedError, match="M9"):
        system.System(atlas, system.Sensor.STEREO, device="cpu")
