"""Standard trial-list verification evaluation (the port's own copy of
``titanet_tpu/train/trials.py``: the same numpy around the port's
embedder, decoder and scoring).

The reference evaluates verification only on all-pairs of its own test
split (the reference's ``src/learn.py:409-459``); it has no support for the
field-standard *trial list* protocol used by every public speaker
benchmark — VoxCeleb1-O/E/H ``veri_test2.txt`` ("<label> <enroll> <test>"
per line) and NIST-SRE / Kaldi ``trials`` files ("<enroll> <test>
target|nontarget"). This module adds that protocol on top of the existing
embedding/scoring stack:

  * :func:`parse_trial_list` — both line formats, comments, validation;
  * :func:`embed_trial_files` — dedup file paths (VoxCeleb lists repeat
    each utterance ~dozens of times), decode + resample on the host, and
    embed every unique file ONCE through a
    :class:`~titanet_torch.train.extractor.SpeakerEmbedder` (geometric
    length buckets, so the full list runs a handful of batch shapes);
  * :func:`trial_scores` — cosine or PLDA trial scores with optional
    S-norm / AS-norm against an impostor cohort;
  * :func:`evaluate_trials` — one call from trial file to
    EER / minDCF / min-Cllr (+ a Kaldi-style ``scores`` output file).

CLI surface: ``python -m titanet_torch trials -p params.yml -c <ckpt>
--trial-file veri_test2.txt --audio-root <wav root>``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TRUE_WORDS = frozenset({"target", "tgt", "true", "1"})
_FALSE_WORDS = frozenset({"nontarget", "imp", "imposter", "impostor",
                          "false", "0"})


def parse_trial_list(path: str) -> Tuple[np.ndarray, List[str], List[str]]:
    """Parse a verification trial list.

    Two whitespace-separated line formats are auto-detected per line:

      * VoxCeleb: ``<0|1> <enroll-path> <test-path>``
      * Kaldi:    ``<enroll-path> <test-path> <target|nontarget>``

    Blank lines and ``#`` comments are skipped. Returns
    ``(labels [N] int64, enroll_paths, test_paths)`` with label 1 = same
    speaker (target trial).
    """
    labels: List[int] = []
    enrolls: List[str] = []
    tests: List[str] = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 3:
                raise ValueError(
                    f"{path}:{lineno}: expected 3 whitespace-separated "
                    f"fields, got {len(parts)}: {line!r}"
                )
            if parts[0] in ("0", "1"):  # VoxCeleb: label first
                lab, enroll, test = int(parts[0]), parts[1], parts[2]
            else:  # Kaldi: verdict word last
                word = parts[2].lower()
                if word in _TRUE_WORDS:
                    lab = 1
                elif word in _FALSE_WORDS:
                    lab = 0
                else:
                    raise ValueError(
                        f"{path}:{lineno}: unrecognized trial verdict "
                        f"{parts[2]!r} (expected target/nontarget or a "
                        f"leading 0/1 label)"
                    )
                enroll, test = parts[0], parts[1]
            labels.append(lab)
            enrolls.append(enroll)
            tests.append(test)
    if not labels:
        raise ValueError(f"{path}: no trials found")
    return np.asarray(labels, np.int64), enrolls, tests


def embed_trial_files(
    paths: Sequence[str],
    embedder,
    *,
    audio_root: Optional[str] = None,
    sample_rate: int = 16000,
) -> Dict[str, np.ndarray]:
    """Embed every *unique* path once; returns ``{path: embedding [E]}``.

    Paths are resolved against ``audio_root`` when given (trial lists are
    conventionally root-relative). Decoding + resampling happen on the
    host; the embedder batches unique files through its geometric length
    buckets, so mixed-length lists stay on a handful of batch shapes.
    """
    from titanet_torch.data.audio_io import read_mono

    unique: List[str] = []
    seen = set()
    for p in paths:
        if p not in seen:
            seen.add(p)
            unique.append(p)
    # Stream in bounded groups: VoxCeleb1-E/H-scale lists (~145k unique
    # files) must not require every decoded waveform resident at once.
    out: Dict[str, np.ndarray] = {}
    group = 512
    for start in range(0, len(unique), group):
        chunk_paths = unique[start:start + group]
        wavs = [read_mono(os.path.join(audio_root, p) if audio_root else p, sample_rate) for p in chunk_paths]
        embs = np.asarray(embedder.embed(wavs), np.float32)
        out.update(zip(chunk_paths, embs))
    return out


def _unit(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def trial_scores(
    embeddings: Dict[str, np.ndarray],
    enrolls: Sequence[str],
    tests: Sequence[str],
    *,
    backend: str = "cosine",
    plda=None,
    cohort_embeddings: Optional[np.ndarray] = None,
    cohort_topk: Optional[int] = None,
) -> np.ndarray:
    """Per-trial scores ``[N]`` from an embedding map.

    ``backend='cosine'`` scores unit-normalized dot products;
    ``backend='plda'`` scores log-likelihood ratios through a fitted
    :class:`~titanet_torch.train.plda.PLDA` (pass it as ``plda``).

    ``cohort_embeddings`` enables S-norm (AS-norm with ``cohort_topk``):
    each trial score is z-normalized against the score distribution of
    both sides vs the impostor cohort — the same statistics as
    :func:`titanet_torch.train.metrics.snorm_scores`, computed per unique
    path so repeated utterances share one set of cohort stats.
    """
    if backend not in ("cosine", "plda"):
        raise ValueError(f"unknown scoring backend {backend!r}")
    if backend == "plda" and plda is None:
        raise ValueError("backend='plda' requires a fitted PLDA model")

    e = np.stack([embeddings[p] for p in enrolls]).astype(np.float64)
    t = np.stack([embeddings[p] for p in tests]).astype(np.float64)
    if backend == "cosine":
        scores = np.sum(_unit(e) * _unit(t), axis=-1)
    else:
        scores = np.asarray(plda.llr(e, t), np.float64)

    if cohort_embeddings is None:
        return scores

    # Per-unique-path cohort statistics (mu, sd over its cohort scores).
    unique = list(embeddings.keys())
    uemb = np.stack([embeddings[p] for p in unique]).astype(np.float64)
    if backend == "cosine":
        cohort = _unit(uemb) @ _unit(cohort_embeddings).T  # [U, C]
    else:
        cohort = np.asarray(
            plda.score_pairs(uemb, np.asarray(cohort_embeddings, np.float64)),
            np.float64,
        )
    if cohort_topk is not None and cohort_topk < cohort.shape[1]:
        part = np.partition(cohort, cohort.shape[1] - cohort_topk, axis=1)
        cohort = part[:, cohort.shape[1] - cohort_topk:]
    mu = dict(zip(unique, cohort.mean(axis=1)))
    sd = dict(zip(unique, np.maximum(cohort.std(axis=1), 1e-12)))
    mu_e = np.asarray([mu[p] for p in enrolls])
    sd_e = np.asarray([sd[p] for p in enrolls])
    mu_t = np.asarray([mu[p] for p in tests])
    sd_t = np.asarray([sd[p] for p in tests])
    return 0.5 * ((scores - mu_e) / sd_e + (scores - mu_t) / sd_t)


def write_scores(path: str, enrolls: Sequence[str], tests: Sequence[str],
                 scores: np.ndarray) -> None:
    """Kaldi-style scores file: ``<enroll> <test> <score>`` per line."""
    with open(path, "w", encoding="utf-8") as fh:
        for e, t, s in zip(enrolls, tests, scores):
            fh.write(f"{e} {t} {s:.6f}\n")


def evaluate_trials(
    trial_path: str,
    embedder,
    *,
    audio_root: Optional[str] = None,
    sample_rate: int = 16000,
    backend: str = "cosine",
    plda=None,
    cohort_embeddings: Optional[np.ndarray] = None,
    cohort_topk: Optional[int] = None,
    p_target: float = 0.01,
    c_fa: float = 1.0,
    c_miss: float = 1.0,
    scores_out: Optional[str] = None,
    det_out: Optional[str] = None,
) -> dict:
    """Trial file -> metrics, end to end.

    Returns ``{"eer", "mindcf", "min_cllr", "n_trials", "n_target",
    "n_nontarget", "n_files"}``; ``min_cllr`` is the PAV-optimal
    calibration-insensitive Cllr (:mod:`titanet_torch.train.calibration`),
    well-defined for raw cosine scores too.
    """
    from titanet_torch.train.calibration import min_cllr
    from titanet_torch.train.metrics import compute_eer, compute_mindcf

    labels, enrolls, tests = parse_trial_list(trial_path)
    embeddings = embed_trial_files(
        list(enrolls) + list(tests), embedder,
        audio_root=audio_root, sample_rate=sample_rate,
    )
    scores = trial_scores(
        embeddings, enrolls, tests, backend=backend, plda=plda,
        cohort_embeddings=cohort_embeddings, cohort_topk=cohort_topk,
    )
    if scores_out:
        write_scores(scores_out, enrolls, tests, scores)
    if det_out:
        from titanet_torch.utils.viz import plot_det_curve

        plot_det_curve((scores, labels), save=det_out)
    return {
        "eer": compute_eer(scores, labels),
        "mindcf": compute_mindcf(
            scores, labels, p_target=p_target, c_fa=c_fa, c_miss=c_miss
        ),
        "min_cllr": min_cllr(scores, labels),
        "n_trials": int(labels.size),
        "n_target": int(labels.sum()),
        "n_nontarget": int(labels.size - labels.sum()),
        "n_files": len(embeddings),
    }
