"""Embedding and spectrogram visualization (port of
``titanet_tpu/utils/viz.py``, numpy and matplotlib as there).

Rebuild of the reference viz utilities (reference
``src/utils.py:66-237``):
2D projection (SVD / t-SNE / UMAP when available), per-speaker scatter with
centroids, outlier trimming, smoothed convex hulls; spectrogram imshow.
Matplotlib is imported lazily and everything degrades to a no-op message if
it is unavailable.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def reduce(embeddings: np.ndarray, n_components: int = 2,
           reduction_method: str = "svd", seed: int = 42) -> np.ndarray:
    """Dimensionality reduction (reference src/utils.py:175-189).
    UMAP falls back to SVD when the package is missing."""
    assert reduction_method in ("svd", "tsne", "umap"), "Unsupported reduction method"
    if reduction_method == "umap":
        try:
            import umap

            return umap.UMAP(
                n_components=n_components, metric="cosine", random_state=seed
            ).fit_transform(embeddings)
        except ImportError:
            reduction_method = "svd"
    if reduction_method == "tsne":
        from sklearn.manifold import TSNE

        return TSNE(
            n_components=n_components, metric="cosine", random_state=seed
        ).fit_transform(embeddings)
    from sklearn.decomposition import TruncatedSVD

    return TruncatedSVD(n_components=n_components, random_state=seed).fit_transform(
        embeddings
    )


def visualize_embeddings(
    embeddings,
    labels: Sequence,
    labels_mapping: Optional[dict] = None,
    reduction_method: str = "svd",
    remove_outliers: bool = False,
    only_centroids: bool = False,
    convex_hull: bool = False,
    figsize=(12, 10),
    legend: bool = False,
    show: bool = False,
    save: Optional[str] = None,
    seed: int = 42,
):
    """Speaker-colored 2D scatter with centroids
    (reference src/utils.py:66-172)."""
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:
        print("[viz disabled: matplotlib unavailable]")
        return None

    embeddings = np.asarray(embeddings)
    labels = np.asarray(labels)
    assert embeddings.ndim == 2 and embeddings.shape[1] > 1
    assert labels.shape[0] == embeddings.shape[0]

    if embeddings.shape[1] > 2:
        embeddings = reduce(embeddings, 2, reduction_method, seed)

    rng = np.random.default_rng(seed)
    fig, ax = plt.subplots(figsize=figsize)
    for label in np.unique(labels):
        pts = embeddings[labels == label]
        color = rng.random(3)
        name = labels_mapping.get(label, label) if labels_mapping else label
        ax.scatter(pts[:, 0].mean(), pts[:, 1].mean(), color=color,
                   label=f"{name} (C)", marker="^", s=250)
        if not only_centroids:
            ax.scatter(pts[:, 0], pts[:, 1], color=color, label=f"{name}")
        if convex_hull and len(pts) >= 3:
            try:
                from scipy import interpolate
                from scipy.spatial import ConvexHull

                hull = ConvexHull(pts)
                xh = np.append(pts[hull.vertices, 0], pts[hull.vertices, 0][0])
                yh = np.append(pts[hull.vertices, 1], pts[hull.vertices, 1][0])
                dist = np.sqrt((xh[:-1] - xh[1:]) ** 2 + (yh[:-1] - yh[1:]) ** 2)
                along = np.concatenate(([0], dist.cumsum()))
                spline, _ = interpolate.splprep([xh, yh], u=along, s=0)
                d = np.linspace(along[0], along[-1], 50)
                ix, iy = interpolate.splev(d, spline)
                ax.fill(ix, iy, "--", color=color, alpha=0.2)
            except Exception:
                pass

    if remove_outliers:
        ax.set_xlim(np.quantile(embeddings[:, 0], 0.01), np.quantile(embeddings[:, 0], 0.99))
        ax.set_ylim(np.quantile(embeddings[:, 1], 0.01), np.quantile(embeddings[:, 1], 0.99))
    if legend:
        plt.legend()
    if save:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        plt.savefig(save)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return save


def play_audio(waveform, sample_rate: int):
    """Notebook audio player (reference src/utils.py:225-237); no-op with a
    message outside IPython."""
    wav = np.asarray(waveform)
    if wav.ndim == 1:
        wav = wav[None]
    try:
        import IPython.display as ipd

        if wav.shape[0] == 1:
            ipd.display(ipd.Audio(wav[0], rate=sample_rate))
        elif wav.shape[0] == 2:
            ipd.display(ipd.Audio((wav[0], wav[1]), rate=sample_rate))
        else:
            raise ValueError("Waveforms with more than 2 channels are not supported")
    except ImportError:
        print(f"[audio: {wav.shape[-1] / sample_rate:.2f}s @ {sample_rate} Hz "
              "(IPython unavailable)]")


def plot_spectrogram(spectrogram, figsize=(12, 3), save: Optional[str] = None,
                     show: bool = False):
    """Spectrogram imshow (reference src/utils.py:200-222); expects
    [frames, mels] or [mels, frames] — displayed frequency-on-y."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    spec = np.asarray(spectrogram)
    if spec.ndim == 3:
        spec = spec[0]
    if spec.shape[0] > spec.shape[1]:  # [frames, mels] -> [mels, frames]
        spec = spec.T
    _, ax = plt.subplots(figsize=figsize)
    img = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(img, ax=ax)
    plt.xlabel("Time")
    plt.ylabel("Frequency")
    plt.tight_layout()
    if save:
        plt.savefig(save)
    if show:
        plt.show()
    else:
        plt.close()
    return save


def plot_det_curve(systems, figsize=(6, 6), save: Optional[str] = None,
                   show: bool = False, min_rate: float = 1e-4):
    """DET curve(s) on normal-deviate (probit) axes — the standard
    speaker-verification plot (beyond the reference, which draws only
    embedding scatters; its verification output is scalar EER/minDCF,
    src/learn.py:437-459).

    ``systems``: either ``(scores, labels)`` for one system or a dict
    ``{name: (scores, labels)}`` to overlay several (e.g. cosine vs
    PLDA backends). Each curve gets its EER point marked. Rates are
    clipped to ``min_rate`` so empty error regions don't explode the
    probit transform.
    """
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:
        print("[viz disabled: matplotlib unavailable]")
        return None
    try:
        from scipy.stats import norm
    except ImportError:
        print("[viz disabled: scipy unavailable]")
        return None

    from titanet_torch.train.metrics import compute_eer, det_curve

    if not isinstance(systems, dict):
        systems = {"": systems}

    fig, ax = plt.subplots(figsize=figsize)
    ticks = [0.001, 0.01, 0.05, 0.1, 0.2, 0.4, 0.6, 0.8]
    for name, (scores, labels) in systems.items():
        fprs, fnrs, _ = det_curve(np.asarray(scores), np.asarray(labels))
        fprs = np.clip(fprs, min_rate, 1 - min_rate)
        fnrs = np.clip(fnrs, min_rate, 1 - min_rate)
        eer = compute_eer(np.asarray(scores), np.asarray(labels))
        label = f"{name} (EER {eer:.2%})".strip()
        (line,) = ax.plot(norm.ppf(fprs), norm.ppf(fnrs), label=label)
        e = norm.ppf(np.clip(eer, min_rate, 1 - min_rate))
        ax.plot([e], [e], "o", color=line.get_color(), markersize=4)
    lim = norm.ppf([min_rate, 1 - min_rate])
    ax.plot(lim, lim, ":", color="gray", linewidth=0.8)  # EER diagonal
    ax.set_xticks(norm.ppf(ticks))
    ax.set_xticklabels([f"{t:g}" for t in ticks])
    ax.set_yticks(norm.ppf(ticks))
    ax.set_yticklabels([f"{t:g}" for t in ticks])
    ax.set_xlim(norm.ppf(min_rate), norm.ppf(0.9))
    ax.set_ylim(norm.ppf(min_rate), norm.ppf(0.9))
    ax.set_xlabel("False acceptance rate")
    ax.set_ylabel("False rejection rate")
    ax.grid(True, linewidth=0.3)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return fig
