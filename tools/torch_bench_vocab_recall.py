#!/usr/bin/env python3
"""Loop and relocalization recall of the shipped vocabulary, for the port.

The counterpart of tools/bench_vocab_recall.py, through the port's own
modules (datasets.synthetic, ops.host_kernels.host_extract_orb,
bow.vocabulary, bow.KeyFrameDatabase): a synthetic revisit sequence
(default 300 frames at 320x240: an outbound sweep that returns over the
same ground) is quantized frame by frame into a keyframe database; every
revisit frame queries it (temporal neighbours excluded) and scores recall@k:
whether a frame of the same ground (within 5 frames of the outbound
partner) is among the top-k candidates.

The default vocabulary is the 32k-word tree, which both packages quantize
on the host, so this bench launches no kernel; a flat vocabulary (where the
tree's file is missing) would quantize on `device` (None: the card).

    python tools/torch_bench_vocab_recall.py [--frames 300] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(n_frames=300, k=5, device=None) -> dict:
    """Prints the JAX tool's lines (the per-vocabulary result, then the JSON
    line) and returns what the JSON line says."""
    from fasttrack_tpu_torch.bow import KeyFrameDatabase
    from fasttrack_tpu_torch.bow.vocabulary import load_default_vocabulary, quantize
    from fasttrack_tpu_torch.datasets.synthetic import _render, make_texture
    from fasttrack_tpu_torch.ops.extractor import OrbConfig
    from fasttrack_tpu_torch.ops.host_kernels import host_extract_orb

    H, W = 240, 320
    cfg = OrbConfig(height=H, width=W, n_features=512, n_levels=4)
    K = np.array([[256.0, 0, W / 2], [0, 256.0, H / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(11)
    tex = make_texture(rng, size=2048)

    # out-and-back sweep: x goes 0 -> 6 -> 0; frame i and frame (N-1-i)
    # view the same ground
    half = n_frames // 2
    xs = np.concatenate([np.linspace(0, 6.0, half), np.linspace(6.0, 0, n_frames - half)])

    results = {}
    for name, voc in [("default", load_default_vocabulary())]:
        db = KeyFrameDatabase()
        bows = []
        t_q = 0.0
        for i in range(n_frames):
            img = _render(tex, 110.0, K, np.eye(3), np.array([xs[i], 0.0, 0.0]), H, W,
                          plane_z=5.0)
            kps = host_extract_orb(img.astype(np.uint8), cfg)
            t0 = time.perf_counter()
            _, bow = quantize(voc, kps.desc_signed, kps.valid, device=device)
            t_q += time.perf_counter() - t0
            bows.append(bow)
            db.add(i, bow)

        hits = total = 0
        for i in range(half + 10, n_frames):
            gt = int(np.argmin(np.abs(xs[:half] - xs[i])))   # the outbound partner
            connected = set(range(i - 20, n_frames))         # neighbours excluded
            cands = db.detect_loop_candidates(bows[i], i, connected, covisible=lambda _: [],
                                              n_best=k)
            total += 1
            if any(abs(c - gt) <= 5 for c in cands):
                hits += 1
        results[name] = {
            "n_words": voc.n_words,
            "recall_at_k": round(hits / max(total, 1), 3),
            "queries": total,
            "quantize_ms_per_frame": round(1e3 * t_q / n_frames, 2),
        }
        print(f"{name}: {results[name]}")
    out = {"bench": "vocab_recall", "k": k, "n_frames": n_frames, **results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--device", default=None, help='"cpu" (default: the card)')
    a = ap.parse_args()
    main(a.frames, a.k, a.device)
