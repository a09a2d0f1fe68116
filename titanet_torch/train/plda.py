"""Two-covariance PLDA scoring backend (Ioffe, ECCV 2006; the standard
production verification scorer — Kaldi/speechbrain ship the same model).
The port's own copy of ``titanet_tpu/train/plda.py``: the same numpy, so
both packages give the same arrays on the same inputs.

No reference counterpart (Wadaboa/titanet scores raw cosines,
src/learn.py:437-439). PLDA models embeddings as ``x = mu + y + e`` with a
between-speaker latent ``y ~ N(0, B)`` and within-speaker noise
``e ~ N(0, W)``, fit by EM on speaker-labeled TRAIN-split embeddings, and
scores a trial with the log-likelihood ratio of the same-speaker vs
different-speaker hypotheses — this weighs embedding directions by how
speaker-discriminative they actually are, where cosine treats all
directions equally.

Implementation notes (host-side numpy; dim is 192 and fitting data is a
few thousand vectors — device offload would be all overhead):

- Length-normalization (unit sphere scaled to sqrt(dim)) is applied inside
  fit/score — the standard Gaussianization step for embedding PLDA.
- EM: per-speaker posterior ``y_s ~ N(m_s, L_s)`` with
  ``L_s = (B^-1 + n_s W^-1)^-1``, ``m_s = L_s W^-1 sum_i x_si``;
  M-step re-estimates B from speaker posteriors and W from residuals.
- Scoring uses Ioffe's simultaneous diagonalization: a transform V with
  ``V W V' = I`` and ``V B V' = diag(psi)`` reduces the LLR to per-dimension
  closed form, so ALL pairs score as one matmul plus rank-1 terms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


def length_norm(x: np.ndarray) -> np.ndarray:
    """Project to the unit sphere scaled to sqrt(dim) (Garcia-Romero &
    Espy-Wilson, Interspeech 2011)."""
    x = np.asarray(x, np.float64)
    norms = np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return x * (np.sqrt(x.shape[-1]) / norms)


@dataclass
class PLDA:
    """Fitted two-covariance PLDA model.

    Attributes: ``mu`` global mean [D]; ``v`` diagonalizing transform
    [D, D] (``v @ W @ v.T = I``, ``v @ B @ v.T = diag(psi)``); ``psi``
    between/within variance ratios per dimension [D].
    """

    mu: np.ndarray
    v: np.ndarray
    psi: np.ndarray

    # ------------------------------------------------------------- fitting
    @classmethod
    def fit(
        cls,
        embeddings: np.ndarray,
        speakers: Sequence,
        n_iter: int = 10,
        eps: float = 1e-6,
        rank: Optional[int] = None,
    ) -> "PLDA":
        """Fit by EM. ``rank`` keeps only the strongest ``rank`` between-
        speaker directions (psi zeroed elsewhere — those dimensions then
        contribute exactly 0 to every LLR): the standard regularization
        when training speakers are scarce relative to the embedding dim
        (B is rank <= n_speakers - 1; small-sample EM otherwise inflates
        psi in unsupported directions). ``rank=None`` keeps all."""
        x = length_norm(embeddings)
        spk = np.asarray(speakers)
        mu = x.mean(0)
        xc = x - mu
        d = x.shape[1]
        uniq = np.unique(spk)
        groups = [xc[spk == s] for s in uniq]
        counts = np.array([len(g) for g in groups])
        sums = np.stack([g.sum(0) for g in groups])

        # scatter initialization
        means = sums / counts[:, None]
        b = (means.T * counts) @ means / counts.sum()
        w = sum(((g - m).T @ (g - m)) for g, m in zip(groups, means))
        w = w / counts.sum()
        b += eps * np.eye(d)
        w += eps * np.eye(d)

        n_total = counts.sum()
        for _ in range(n_iter):
            b_inv = np.linalg.inv(b)
            w_inv = np.linalg.inv(w)
            new_b = np.zeros_like(b)
            new_w = np.zeros_like(w)
            for g, n_s, s_sum in zip(groups, counts, sums):
                l_s = np.linalg.inv(b_inv + n_s * w_inv)
                m_s = l_s @ (w_inv @ s_sum)
                new_b += np.outer(m_s, m_s) + l_s
                r = g - m_s
                new_w += r.T @ r + n_s * l_s
            b = new_b / len(groups) + eps * np.eye(d)
            w = new_w / n_total + eps * np.eye(d)

        # simultaneous diagonalization: whiten W, rotate to diagonalize B
        w_vals, w_vecs = np.linalg.eigh(w)
        whiten = w_vecs / np.sqrt(np.maximum(w_vals, eps))
        b_t = whiten.T @ b @ whiten
        psi, rot = np.linalg.eigh(b_t)
        v = (whiten @ rot).T  # v @ w @ v.T = I, v @ b @ v.T = diag(psi)
        psi = np.maximum(psi, 0.0)
        if rank is not None and rank < len(psi):
            cut = np.sort(psi)[-rank - 1]
            psi = np.where(psi > cut, psi, 0.0)
        return cls(mu=mu, v=v, psi=psi)

    # ------------------------------------------------------------- scoring
    def _latent(self, embeddings: np.ndarray) -> np.ndarray:
        return (length_norm(embeddings) - self.mu) @ self.v.T

    def score_pairs(
        self, enroll: np.ndarray, test: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """All-pairs log-likelihood-ratio matrix ``[N, M]``.

        Per diagonalized dimension with ratio psi (a = 1 + psi, b = psi):
          llr_d = -0.5 * [ (a*(u1^2+u2^2) - 2*b*u1*u2) / (a^2 - b^2)
                           + log(a^2 - b^2) ]
                  +0.5 * [ (u1^2 + u2^2) / a + 2*log a ]
        which splits into per-vector terms (rank-1 row/col additions) and
        one cross matmul with diagonal weights — O(N*M*D), vectorized.
        """
        u1 = self._latent(enroll)
        u2 = self._latent(test) if test is not None else u1
        a = 1.0 + self.psi
        b = self.psi
        det = a * a - b * b  # = 1 + 2*psi
        # quadratic self terms: coefficient on u^2
        q = -0.5 * a / det + 0.5 / a
        # cross term coefficient on u1*u2
        c = b / det
        const = -0.5 * np.sum(np.log(det)) + np.sum(np.log(a))
        row = (u1 * u1) @ q  # [N]
        col = (u2 * u2) @ q  # [M]
        cross = (u1 * c) @ u2.T  # [N, M]
        return row[:, None] + col[None, :] + cross + const

    def llr(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        """Elementwise LLR for paired rows of x1/x2 (both [N, D]) -> [N]."""
        u1 = self._latent(np.atleast_2d(x1))
        u2 = self._latent(np.atleast_2d(x2))
        a = 1.0 + self.psi
        b = self.psi
        det = a * a - b * b
        q = -0.5 * a / det + 0.5 / a
        c = b / det
        const = -0.5 * np.sum(np.log(det)) + np.sum(np.log(a))
        return (u1 * u1) @ q + (u2 * u2) @ q + ((u1 * c) * u2).sum(-1) + const
