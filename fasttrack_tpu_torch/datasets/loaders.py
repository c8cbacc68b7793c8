"""Dataset directory loaders (the reference's Examples/*/ LoadImages code).

Port of fasttrack_tpu/datasets/loaders.py: the EuRoC, TUM-VI, KITTI and
TUM RGB-D loaders (pure Python and NumPy).

All loaders are lazy: they index timestamps + paths up front and decode
images on demand (PIL; OpenCV if available). Grayscale float32 output.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode to grayscale float32 (H, W)."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img.astype(np.float32)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


@dataclass
class ImuData:
    t: np.ndarray       # (M,) seconds
    gyro: np.ndarray    # (M, 3)
    acc: np.ndarray     # (M, 3)

    def between(self, t0: float, t1: float):
        """Samples in (t0, t1] as (t, acc, gyro) tuples — the exact shape
        Tracker.grab_imu / System.track_*(imu=...) consume."""
        idx = np.where((self.t > t0) & (self.t <= t1))[0]
        return [(float(self.t[i]), self.acc[i], self.gyro[i]) for i in idx]


def _read_imu_csv(root: str) -> ImuData | None:
    """mav0/imu0/data.csv (ns, gyro xyz, acc xyz), or None without one."""
    imu_csv = os.path.join(root, "mav0", "imu0", "data.csv")
    if not os.path.exists(imu_csv):
        return None
    rows = []
    with open(imu_csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append([float(x) for x in row])
    arr = np.asarray(rows)
    return ImuData(arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:7])


@dataclass
class EurocSequence:
    """EuRoC ASL layout: mav0/cam0/data/<ns>.png, cam1, imu0/data.csv.

    Matches stereo_inertial_euroc.cc LoadImages/LoadIMU: timestamps come
    from the EuRoC_TimeStamps file when given, else from the cam0 csv.
    """

    root: str
    timestamps_file: str | None = None
    timestamps: np.ndarray = field(init=False)
    left_paths: list = field(init=False)
    right_paths: list = field(init=False)
    imu: ImuData | None = field(init=False, default=None)

    def __post_init__(self):
        cam0 = os.path.join(self.root, "mav0", "cam0", "data")
        cam1 = os.path.join(self.root, "mav0", "cam1", "data")
        if self.timestamps_file:
            with open(self.timestamps_file) as f:
                stamps = [line.strip() for line in f if line.strip()]
        else:
            stamps = sorted(os.path.splitext(p)[0] for p in os.listdir(cam0))
        self.timestamps = np.asarray([int(s) * 1e-9 for s in stamps])
        self.left_paths = [os.path.join(cam0, s + ".png") for s in stamps]
        self.right_paths = [os.path.join(cam1, s + ".png") for s in stamps]
        self.imu = _read_imu_csv(self.root)

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i):
        return (
            self.timestamps[i],
            load_image(self.left_paths[i]),
            load_image(self.right_paths[i]),
        )


@dataclass
class TumViSequence:
    """TUM-VI in the EuRoC mav0 layout it is distributed in:
    mav0/cam0/data/<ns>.png, cam1, imu0/data.csv."""

    root: str
    timestamps: np.ndarray = field(init=False)
    left_paths: list = field(init=False)
    right_paths: list = field(init=False)
    imu: ImuData | None = field(init=False, default=None)

    def __post_init__(self):
        cam0 = os.path.join(self.root, "mav0", "cam0", "data")
        cam1 = os.path.join(self.root, "mav0", "cam1", "data")
        stamps = sorted(os.path.splitext(p)[0] for p in os.listdir(cam0))
        self.timestamps = np.asarray([int(s) * 1e-9 for s in stamps])
        self.left_paths = [os.path.join(cam0, s + ".png") for s in stamps]
        self.right_paths = [os.path.join(cam1, s + ".png") for s in stamps]
        self.imu = _read_imu_csv(self.root)

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i):
        return (
            self.timestamps[i],
            load_image(self.left_paths[i]),
            load_image(self.right_paths[i]),
        )


@dataclass
class KittiSequence:
    """KITTI odometry layout: image_0/<%06d>.png, image_1/, times.txt."""

    root: str
    timestamps: np.ndarray = field(init=False)
    left_paths: list = field(init=False)
    right_paths: list = field(init=False)

    def __post_init__(self):
        with open(os.path.join(self.root, "times.txt")) as f:
            self.timestamps = np.asarray([float(x) for x in f if x.strip()])
        n = len(self.timestamps)
        self.left_paths = [os.path.join(self.root, "image_0", f"{i:06d}.png") for i in range(n)]
        self.right_paths = [os.path.join(self.root, "image_1", f"{i:06d}.png") for i in range(n)]

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i):
        return (
            self.timestamps[i],
            load_image(self.left_paths[i]),
            load_image(self.right_paths[i]),
        )


@dataclass
class TumRgbdSequence:
    """TUM RGB-D layout: rgb.txt + depth.txt with '<t> <path>' lines,
    associated by nearest timestamp (the classic associate.py logic): an
    RGB frame keeps the depth map nearest in time if it lies within
    `max_dt` seconds, else the frame is left out. A depth PNG holds 16-bit
    values that `depth_factor` (5000 in the TUM RGB-D distribution) turns
    into metres; 0 is no depth."""

    root: str
    max_dt: float = 0.02
    timestamps: np.ndarray = field(init=False)
    rgb_paths: list = field(init=False)
    depth_paths: list = field(init=False)
    depth_factor: float = 5000.0

    def __post_init__(self):
        def read_list(name):
            out = []
            with open(os.path.join(self.root, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    t, p = line.split()[:2]
                    out.append((float(t), p))
            return out

        rgb = read_list("rgb.txt")
        depth = read_list("depth.txt")
        dts = np.asarray([t for t, _ in depth])
        stamps, rgbs, depths = [], [], []
        for t, p in rgb:
            j = int(np.argmin(np.abs(dts - t)))
            if abs(dts[j] - t) <= self.max_dt:
                stamps.append(t)
                rgbs.append(os.path.join(self.root, p))
                depths.append(os.path.join(self.root, depth[j][1]))
        self.timestamps = np.asarray(stamps)
        self.rgb_paths = rgbs
        self.depth_paths = depths

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i):
        """(timestamp, grayscale float32 image, float32 depth in metres)."""
        rgb = load_image(self.rgb_paths[i])
        try:
            import cv2

            d = cv2.imread(self.depth_paths[i], cv2.IMREAD_UNCHANGED)
        except ImportError:
            from PIL import Image

            d = np.asarray(Image.open(self.depth_paths[i]))
        depth = d.astype(np.float32) / self.depth_factor
        return self.timestamps[i], rgb, depth
