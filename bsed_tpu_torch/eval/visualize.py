"""Embedding-space domain audits: t-SNE scatter + SVM separability probe.

The port's copy of ``bsed_tpu/eval/visualize.py`` (numpy, scikit-learn
and matplotlib; no torch). scikit-learn is imported inside the functions,
so the module imports without it; the CLI's ``visualize`` exits naming it
where it is missing.

Reference: src/visualize.py —
  * ``visualization`` (:22-99): t-SNE of synthetic-vs-real encoder
    embeddings with silhouette score.
  * ``svm_classfication`` (:103-121): 5-fold SVM domain-classification
    accuracy — LOW accuracy means domains are well aligned (good DA).

matplotlib may be absent; plotting then degrades to returning the 2-D
coordinates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _flatten(emb: np.ndarray) -> np.ndarray:
    """(N, T, D) → (N, T·D) clip vectors (visualize.py flattens per clip)."""
    return emb.reshape(emb.shape[0], -1)


def tsne_domain_audit(syn_emb: np.ndarray, real_emb: np.ndarray,
                      perplexity: float = 30.0, seed: int = 0,
                      plot_path: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Returns (2-D points, domain labels, silhouette score)."""
    from sklearn.manifold import TSNE
    from sklearn.metrics import silhouette_score

    x = np.concatenate([_flatten(syn_emb), _flatten(real_emb)], axis=0)
    y = np.concatenate([np.zeros(len(syn_emb)), np.ones(len(real_emb))])
    perplexity = min(perplexity, max(2.0, (len(x) - 1) / 3))
    pts = TSNE(n_components=2, perplexity=perplexity,
               random_state=seed, init="pca").fit_transform(x)
    sil = float(silhouette_score(pts, y)) if len(np.unique(y)) > 1 else 0.0

    if plot_path:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6, 6))
            ax.scatter(pts[y == 0, 0], pts[y == 0, 1], s=4, label="SYN")
            ax.scatter(pts[y == 1, 0], pts[y == 1, 1], s=4, label="ENA")
            ax.legend()
            ax.set_title(f"silhouette={sil:.3f}")
            fig.savefig(plot_path, dpi=120)
            plt.close(fig)
        except ImportError:
            pass
    return pts, y, sil


def project_embeddings(emb: np.ndarray, method: str = "pca",
                       n_components: int = 2, seed: int = 0) -> np.ndarray:
    """PCA/ICA projections (save_features_test.py variants)."""
    x = _flatten(emb)
    if method == "pca":
        from sklearn.decomposition import PCA
        return PCA(n_components=n_components,
                   random_state=seed).fit_transform(x)
    if method == "ica":
        from sklearn.decomposition import FastICA
        return FastICA(n_components=n_components,
                       random_state=seed).fit_transform(x)
    raise ValueError(method)


def svm_domain_accuracy(syn_emb: np.ndarray, real_emb: np.ndarray,
                        folds: int = 5, seed: int = 0) -> float:
    """5-fold SVM accuracy at telling domains apart (visualize.py:103-121).
    ~0.5 = domains aligned; ~1.0 = fully separable (no adaptation)."""
    from sklearn.model_selection import cross_val_score
    from sklearn.svm import SVC

    x = np.concatenate([_flatten(syn_emb), _flatten(real_emb)], axis=0)
    y = np.concatenate([np.zeros(len(syn_emb)), np.ones(len(real_emb))])
    folds = min(folds, int(np.bincount(y.astype(int)).min()))
    scores = cross_val_score(SVC(kernel="rbf"), x, y, cv=max(folds, 2))
    return float(scores.mean())
