"""Speaker enrollment / verification / identification registry (the
port's own copy of ``titanet_tpu/train/enroll.py``; its JSON files read
in both packages).

The reference stops at embeddings + offline all-pairs evaluation
(the reference's ``src/learn.py:409-493``); a deployed speaker system also
needs the enrollment layer: register speakers from a few utterances, then
answer "is this X?" (verification) and "who is this?" (open-set
identification). This module is that layer, built on the package's own
primitives:

- profiles are length-normalized mean embeddings (the standard multi-
  enrollment recipe; adding utterances updates the running mean),
- scoring is cosine against every profile — one ``[N, E] @ [E, P]`` matmul,
- thresholds operate on CALIBRATED log-likelihood ratios when a
  :class:`titanet_torch.train.calibration.LogisticCalibration` is attached
  (fit one on dev trials; then ``accept = llr > 0`` IS the Bayes decision
  at the calibration prior), falling back to raw-cosine thresholds,
- open-set identification returns ``None`` when no profile clears the
  threshold.

Host-side numpy over precomputed embeddings: pair it with
:class:`titanet_torch.train.extractor.SpeakerEmbedder` (device-batched
wav -> embedding) for the full serving path — see :mod:`titanet_torch.serve`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _l2(x: np.ndarray, axis: int = -1) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


class SpeakerRegistry:
    """Enroll / verify / identify over unit-norm speaker embeddings."""

    def __init__(self, threshold: float = 0.5, calibration=None):
        # threshold semantics: a raw-cosine floor without calibration, an
        # LLR floor (0.0 = Bayes at the calibration prior) with one
        self.threshold = float(threshold)
        self.calibration = calibration
        self._sums: Dict[str, np.ndarray] = {}
        self._counts: Dict[str, int] = {}

    # -- enrollment ---------------------------------------------------------
    def enroll(self, name: str, embeddings: np.ndarray) -> None:
        """Add one ``[E]`` or several ``[K, E]`` embeddings to ``name``'s
        profile (creates it on first call). Profiles are running means of
        the length-normalized enrollment embeddings."""
        emb = np.atleast_2d(np.asarray(embeddings, np.float64))
        emb = _l2(emb)
        if name in self._sums:
            self._sums[name] = self._sums[name] + emb.sum(axis=0)
            self._counts[name] += emb.shape[0]
        else:
            self._sums[name] = emb.sum(axis=0)
            self._counts[name] = emb.shape[0]

    def remove(self, name: str) -> bool:
        existed = name in self._sums
        self._sums.pop(name, None)
        self._counts.pop(name, None)
        return existed

    @property
    def speakers(self) -> List[str]:
        return sorted(self._sums)

    def profile(self, name: str) -> np.ndarray:
        """Length-normalized mean enrollment embedding ``[E]``."""
        return _l2(self._sums[name] / self._counts[name])

    # -- scoring ------------------------------------------------------------
    def _score_matrix(self, embeddings: np.ndarray) -> Tuple[np.ndarray, List[str]]:
        names = self.speakers
        if not names:
            raise ValueError("no enrolled speakers")
        profiles = np.stack([self.profile(n) for n in names], axis=1)  # [E, P]
        scores = _l2(np.atleast_2d(np.asarray(embeddings, np.float64))) @ profiles
        if self.calibration is not None:
            scores = self.calibration(scores)
        return scores, names

    def verify(self, name: str, embedding: np.ndarray) -> Tuple[bool, float]:
        """``(accept, score)`` for the claim "this is ``name``"."""
        scores, names = self._score_matrix(embedding)
        score = float(scores[0, names.index(name)])
        return score > self.threshold, score

    def identify(
        self, embeddings: np.ndarray, top_k: int = 1
    ) -> List[List[Tuple[Optional[str], float]]]:
        """Open-set identification: per input embedding, the ``top_k``
        ``(speaker, score)`` candidates, with speaker ``None`` when the
        best score does not clear the threshold (unknown speaker)."""
        scores, names = self._score_matrix(embeddings)
        out = []
        for row in scores:
            order = np.argsort(row)[::-1][:top_k]
            cands = [(names[int(i)], float(row[int(i)])) for i in order]
            if cands and cands[0][1] <= self.threshold:
                cands[0] = (None, cands[0][1])
            out.append(cands)
        return out

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """One JSON file: profiles (running sums + counts), threshold,
        calibration coefficients."""
        data = {
            "threshold": self.threshold,
            "calibration": (
                {"a": self.calibration.a, "b": self.calibration.b}
                if self.calibration is not None else None
            ),
            "speakers": {
                n: {"sum": self._sums[n].tolist(), "count": self._counts[n]}
                for n in self._sums
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "SpeakerRegistry":
        with open(path) as f:
            data = json.load(f)
        cal = None
        if data.get("calibration"):
            from titanet_torch.train.calibration import LogisticCalibration

            cal = LogisticCalibration(
                data["calibration"]["a"], data["calibration"]["b"]
            )
        reg = cls(threshold=data["threshold"], calibration=cal)
        for name, p in data["speakers"].items():
            reg._sums[name] = np.asarray(p["sum"], np.float64)
            reg._counts[name] = int(p["count"])
        return reg


def registry_from_trials(
    enroll_embeddings: Sequence[np.ndarray],
    enroll_names: Sequence[str],
    dev_scores: Optional[np.ndarray] = None,
    dev_labels: Optional[np.ndarray] = None,
) -> SpeakerRegistry:
    """Build a registry; when labeled dev trials are given, fit logistic
    calibration on them and threshold at the Bayes point (llr > 0)."""
    cal = None
    threshold = 0.5
    if dev_scores is not None and dev_labels is not None:
        from titanet_torch.train.calibration import LogisticCalibration

        cal = LogisticCalibration.fit(dev_scores, dev_labels)
        threshold = 0.0
    reg = SpeakerRegistry(threshold=threshold, calibration=cal)
    for emb, name in zip(enroll_embeddings, enroll_names):
        reg.enroll(name, emb)
    return reg
