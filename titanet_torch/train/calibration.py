"""Verification score calibration: logistic LLR calibration, Cllr, actual
DCF (the port's own copy of ``titanet_tpu/train/calibration.py``, numpy).

Beyond the reference (whose test path reports EER + minDCF only,
the reference's ``src/learn.py:409-459``, ``src/utils.py:294-367``): raw
cosine scores are not log-likelihood ratios, so a deployed system cannot
threshold them at the Bayes point. The standard fix (Brümmer & du Preez,
"Application-independent evaluation of speaker detection", 2006) is

- **logistic calibration**: an affine map ``llr = a*s + b`` fitted by
  logistic regression on labeled dev trials (here: all-pairs trials from
  the train-split cohort the S-norm machinery already embeds),
- **Cllr** (bits): the proper scoring rule that measures both
  discrimination and calibration of the produced LLRs,
- **min Cllr**: Cllr after the PAV-optimal (isotonic) calibration — the
  calibration-free lower bound; the gap Cllr - minCllr is pure
  miscalibration,
- **actual DCF**: the detection cost when thresholding the calibrated LLRs
  at the Bayes threshold ``-log(p_t c_miss / ((1-p_t) c_fa))`` — what a
  deployment actually pays, vs minDCF's oracle threshold.

Pure numpy (host-side post-processing of [N] score vectors; the heavy
all-pairs scoring already runs batched on device upstream).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def cllr(llrs: np.ndarray, labels: np.ndarray) -> float:
    """Cost of log-likelihood ratio (bits): ``0.5 * (mean_tar log2(1+e^-l)
    + mean_non log2(1+e^l))``. 0 = perfect, 1 = an uninformative llr=0
    system; >1 means the scores are actively miscalibrated."""
    llrs = np.asarray(llrs, np.float64)
    labels = np.asarray(labels).astype(bool)
    assert labels.any() and (~labels).any(), "need both trial classes"
    c_tar = np.mean(np.logaddexp(0.0, -llrs[labels]))
    c_non = np.mean(np.logaddexp(0.0, llrs[~labels]))
    return float(0.5 * (c_tar + c_non) / np.log(2.0))


def pav_posteriors(scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Isotonic (pool-adjacent-violators) fit of ``P(target | score)``,
    returned in the input trial order. The PAV solution is the optimal
    monotone calibration for any proper scoring rule."""
    scores = np.asarray(scores, np.float64)
    y = np.asarray(labels, np.float64)
    order = np.argsort(scores, kind="stable")
    y_sorted = y[order]
    # blocks as (sum, count) stacks; merge while decreasing
    sums, counts = [], []
    for v in y_sorted:
        sums.append(float(v))
        counts.append(1)
        while len(sums) > 1 and sums[-2] * counts[-1] >= sums[-1] * counts[-2]:
            s, c = sums.pop(), counts.pop()
            sums[-1] += s
            counts[-1] += c
    fitted = np.concatenate([
        np.full(c, s / c) for s, c in zip(sums, counts)
    ])
    out = np.empty_like(fitted)
    out[order] = fitted
    return out


def pav_llrs(scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """PAV-optimal LLRs: ``logit(P(tar|s)) - log(N_tar/N_non)`` (the
    empirical prior log-odds are removed so the output is a likelihood
    ratio, not a posterior)."""
    labels = np.asarray(labels).astype(bool)
    p = np.clip(pav_posteriors(scores, labels), _EPS, 1.0 - _EPS)
    prior_logodds = np.log(labels.sum() / max((~labels).sum(), 1))
    return np.log(p / (1.0 - p)) - prior_logodds


def min_cllr(scores: np.ndarray, labels: np.ndarray) -> float:
    """Cllr after optimal (PAV) calibration — the discrimination floor."""
    return cllr(pav_llrs(scores, labels), labels)


class LogisticCalibration:
    """Affine LLR calibration ``llr = a*s + b`` by logistic regression.

    Fitted with Newton-Raphson (2 parameters, converges in a handful of
    steps); the empirical prior log-odds are subtracted from the intercept
    so ``__call__`` emits proper LLRs regardless of the dev trial mix.
    """

    def __init__(self, a: float, b: float):
        self.a = float(a)
        self.b = float(b)

    @classmethod
    def fit(cls, scores: np.ndarray, labels: np.ndarray,
            n_iter: int = 50, ridge: float = 1e-6) -> "LogisticCalibration":
        s = np.asarray(scores, np.float64)
        y = np.asarray(labels).astype(np.float64)
        assert (y > 0).any() and (y == 0).any(), "need both trial classes"
        x = np.stack([s, np.ones_like(s)], axis=1)  # [N, 2]
        w = np.zeros(2)
        for _ in range(n_iter):
            z = x @ w
            p = 1.0 / (1.0 + np.exp(-z))
            g = x.T @ (p - y)
            r = np.clip(p * (1.0 - p), _EPS, None)
            h = (x * r[:, None]).T @ x + ridge * np.eye(2)
            step = np.linalg.solve(h, g)
            w = w - step
            if np.max(np.abs(step)) < 1e-10:
                break
        prior_logodds = np.log(y.sum() / max((y == 0).sum(), 1))
        return cls(w[0], w[1] - prior_logodds)

    def __call__(self, scores: np.ndarray) -> np.ndarray:
        return self.a * np.asarray(scores, np.float64) + self.b


def actual_dcf(
    llrs: np.ndarray,
    labels: np.ndarray,
    p_target: float = 0.01,
    c_fa: float = 1.0,
    c_miss: float = 1.0,
) -> float:
    """Normalized detection cost at the BAYES threshold
    ``-log(p_t c_miss / ((1-p_t) c_fa))`` — the cost a deployment pays when
    it trusts the LLRs (vs minDCF's oracle threshold; actDCF >= minDCF,
    and the gap is the calibration loss at this operating point)."""
    llrs = np.asarray(llrs, np.float64)
    labels = np.asarray(labels).astype(bool)
    thr = -np.log((p_target * c_miss) / ((1.0 - p_target) * c_fa) + _EPS)
    p_miss = float(np.mean(llrs[labels] < thr)) if labels.any() else 0.0
    p_fa = float(np.mean(llrs[~labels] >= thr)) if (~labels).any() else 0.0
    cost = c_miss * p_target * p_miss + c_fa * (1.0 - p_target) * p_fa
    c_def = min(c_miss * p_target, c_fa * (1.0 - p_target))
    return float(cost / (c_def + _EPS))
