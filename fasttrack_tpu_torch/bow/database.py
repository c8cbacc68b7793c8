"""Inverted-index keyframe database (src/KeyFrameDatabase.cc).

Port of fasttrack_tpu/bow/database.py, a copy (host dicts).

Word -> keyframe inverted file with the reference's candidate logic:
common-word counting, 0.8*max-common-words pruning, covisibility-group
accumulated scores, and the best-N selection used for loop/merge detection
(DetectNBestCandidates, KeyFrameDatabase.cc:604) and relocalization
(DetectRelocalizationCandidates, :733).
"""

from __future__ import annotations

from collections import defaultdict

from fasttrack_tpu_torch.bow.vocabulary import l1_score


class KeyFrameDatabase:
    def __init__(self):
        self.inverted: dict[int, set[int]] = defaultdict(set)
        self.kf_bows: dict[int, dict] = {}

    def add(self, kf_id: int, bow: dict):
        self.kf_bows[kf_id] = bow
        for w in bow:
            self.inverted[w].add(kf_id)

    def erase(self, kf_id: int):
        bow = self.kf_bows.pop(kf_id, None)
        if bow is None:
            return
        for w in bow:
            self.inverted[w].discard(kf_id)

    def clear(self):
        self.inverted.clear()
        self.kf_bows.clear()

    def _common_word_scores(self, bow: dict, exclude: set[int]):
        shared: dict[int, int] = defaultdict(int)
        for w in bow:
            for kf_id in self.inverted.get(w, ()):
                if kf_id not in exclude:
                    shared[kf_id] += 1
        if not shared:
            return {}
        max_common = max(shared.values())
        min_common = max(int(0.8 * max_common), 1)
        return {
            k: l1_score(bow, self.kf_bows[k])
            for k, c in shared.items()
            if c >= min_common
        }

    def detect_candidates(
        self,
        bow: dict,
        exclude: set[int] | None = None,
        covisible=None,
        n_best: int = 3,
        min_score: float = 0.0,
    ) -> list[int]:
        """Best-N candidates by covisibility-group accumulated score
        (DetectNBestCandidates semantics). `covisible` maps kf_id to its
        covisible neighbor ids — a dict, or a CALLABLE resolved lazily only
        for keyframes that actually share words with the query (the whole
        database never needs materializing); when None, each KF is its own
        group."""
        exclude = exclude or set()
        scores = self._common_word_scores(bow, exclude)
        if not scores:
            return []
        groups = []
        for kf_id, sc in scores.items():
            if sc < min_score:
                continue
            if covisible is None:
                group = [kf_id]
            elif callable(covisible):
                group = [kf_id] + list(covisible(kf_id) or [])
            else:
                group = [kf_id] + covisible.get(kf_id, [])
            acc = sc
            best_kf, best_sc = kf_id, sc
            for nid in group[1:]:
                nsc = scores.get(nid)
                if nsc is not None:
                    acc += nsc
                    if nsc > best_sc:
                        best_kf, best_sc = nid, nsc
            groups.append((acc, best_kf))
        groups.sort(key=lambda g: -g[0])
        out, seen = [], set()
        for _, kf_id in groups:
            if kf_id not in seen:
                seen.add(kf_id)
                out.append(kf_id)
            if len(out) >= n_best:
                break
        return out

    def detect_relocalization_candidates(self, bow: dict,
                                         covisible=None, n_best: int = 5):
        return self.detect_candidates(bow, exclude=set(), covisible=covisible,
                                      n_best=n_best)

    def detect_loop_candidates(self, bow: dict, kf_id: int,
                               connected: set[int], covisible=None,
                               min_score: float = 0.0, n_best: int = 3):
        """Loop candidates must not be covisibly connected to the query
        (KeyFrameDatabase::DetectLoopCandidates)."""
        exclude = {kf_id} | connected
        return self.detect_candidates(bow, exclude=exclude, covisible=covisible,
                                      n_best=n_best, min_score=min_score)
