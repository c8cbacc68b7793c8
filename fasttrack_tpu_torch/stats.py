"""Per-stage timing statistics (the reference's Stats subsystem,
include/Stats.h:20-42 / src/Stats.cc).

Records per-frame stage timings (tracking total, ORB extraction, stereo
match, TWM/TLM and sub-stages) and arbitrary counters; `save(dir)` writes
one text file per series in the reference's `<frame>: <ms>` format
(Stats::saveStats) so the reference's plotting/aggregation workflow applies
unchanged. Always on (the reference gates this behind REGISTER_STATS;
recording here costs a dict append per stage).

Port of fasttrack_tpu/stats.py (same series names, same save format).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict


class Stats:
    def __init__(self):
        self.series: dict[str, list[float]] = defaultdict(list)

    def record(self, name: str, value_ms: float):
        self.series[name].append(float(value_ms))

    def record_count(self, name: str, value: int):
        self.series[name].append(float(value))

    def mean(self, name: str) -> float:
        s = self.series.get(name)
        return sum(s) / len(s) if s else 0.0

    def summary(self) -> dict:
        return {
            k: {
                "mean": self.mean(k),
                "n": len(v),
                "max": max(v) if v else 0.0,
            }
            for k, v in self.series.items()
        }

    def save(self, directory: str):
        """Stats::saveStats format: '<index>: <value>' lines per series,
        under <dir>/data/ (Stats.cc:29)."""
        out = os.path.join(directory, "data")
        os.makedirs(out, exist_ok=True)
        for name, values in self.series.items():
            with open(os.path.join(out, f"{name}.txt"), "w") as f:
                for i, v in enumerate(values):
                    f.write(f"{i}: {v:.4f}\n")
        with open(os.path.join(directory, "summary.json"), "w") as f:
            json.dump(self.summary(), f, indent=2)
