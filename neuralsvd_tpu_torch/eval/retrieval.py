"""Cross-domain retrieval evaluation (Sketchy CDK benchmark).

Port of ``neuralsvd_tpu/eval/retrieval.py``: brute-force scores as one
``torch.matmul`` per query batch on the device (inner products, or negative
squared distances) and ``torch.topk``; this product sits outside any
kernel in the JAX package too.  P@K and the three mAP conventions
(``precision_at_k``, ``average_precisions``) are numpy, copied.

``torch.topk`` and ``jax.lax.top_k`` may order tied scores differently.
"""
from __future__ import annotations

import os
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from neuralsvd_tpu_torch.device import resolve_device


def _scores(queries, gallery, metric: str):
    if metric == "inner_product":
        return torch.matmul(queries, gallery.T)
    if metric == "euclidean":
        sq = ((queries ** 2).sum(-1)[:, None]
              - 2 * torch.matmul(queries, gallery.T)
              + (gallery ** 2).sum(-1)[None, :])
        return -sq
    raise NotImplementedError(metric)


def top_k_retrievals(zxs, zys, K: Optional[int] = None,
                     metric: str = "inner_product", batch: int = 2048,
                     device=None):
    """(Q, K) gallery indices ranked by score, best first (numpy)."""
    dev = resolve_device(device)
    zxs = np.asarray(zxs, np.float32)
    K = K or len(zys)
    gallery = torch.as_tensor(np.asarray(zys, np.float32), device=dev)
    out = []
    with torch.no_grad():
        for i in range(0, len(zxs), batch):
            q = torch.as_tensor(zxs[i:i + batch], device=dev)
            out.append(torch.topk(_scores(q, gallery, metric), K, dim=1).indices
                       .cpu().numpy())
    return np.concatenate(out, axis=0)


def get_retrievals(zxs, zys, xclss, yclss, K=None, metric="inner_product",
                   device=None):
    idx = top_k_retrievals(zxs, zys, K, metric, device=device)
    relevances = (np.asarray(yclss)[idx] == np.asarray(xclss)[:, None])
    return relevances, idx


def precision_at_k(relevances: np.ndarray) -> np.ndarray:
    """(n_queries, K) -> (n_queries,) P@K."""
    return relevances.mean(axis=1)


def average_precisions(relevances: np.ndarray, n_relevant_items, ver: int = 1):
    """AP per query; ver 1 (optimistic interpolation), 2 (over min(K, n
    relevant)) or 3 (over the hits found)."""
    relevances = np.asarray(relevances)
    precs = relevances.cumsum(axis=1) / np.arange(
        1, relevances.shape[1] + 1)[None, :]
    if ver == 1:
        # optimistic interpolation (running max from the right)
        max_precs = np.maximum.accumulate(precs[:, ::-1], axis=1)[:, ::-1]
        counts = relevances.sum(axis=1)
        sums = (max_precs * relevances).sum(axis=1)
        return np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    if ver == 2:
        K = relevances.shape[1]
        return ((precs * relevances).sum(-1)
                / np.minimum(K, np.asarray(n_relevant_items)))
    if ver == 3:
        gt_cnts = relevances.sum(axis=-1)
        return np.where(gt_cnts > 0,
                        (precs * relevances).sum(axis=1)
                        / np.maximum(gt_cnts, 1), 0.0)
    raise NotImplementedError(f"ap_ver={ver}")


class Retrieval:
    """Embed test sketches/photos with the trained towers and score P@K/mAP.

    ``test_loader`` exposes sketch_features/photo_features and
    sketch_classes/photo_classes (SketchyVGGDataLoader or ArrayPairLoader).
    Features go to ``device`` (default: the GPU) in batches of
    ``batch_size``; embeddings come back to numpy.
    """

    def __init__(self, test_loader, n_retrievals: int = 100,
                 metric: str = "inner_product", batch_size: int = 4096,
                 device=None):
        self.loader = test_loader
        self.n_retrievals = n_retrievals
        self.metric = metric
        self.batch_size = batch_size
        self.device = resolve_device(device)
        counts = Counter(test_loader.sketch_classes.tolist())
        self.n_classes_items = np.array(
            [counts[c] for c in test_loader.sketch_classes.tolist()])

    def _embed(self, fn: Callable, feats: np.ndarray) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(feats), self.batch_size):
                v = torch.as_tensor(np.asarray(feats[i:i + self.batch_size],
                                               np.float32), device=self.device)
                out.append(fn(v).cpu().numpy())
        return np.concatenate(out, axis=0)

    def evaluate(self, model_x: Callable, model_y: Callable,
                 ap_ver: int = 1, return_map_all: bool = False, tag: str = "",
                 trunc_dim: Optional[int] = None,
                 perm: Optional[np.ndarray] = None):
        """Returns (precision_Ks, average_precisions_per_query).

        ``trunc_dim`` keeps only the first d embedding dims (negative d
        keeps the LAST |d| dims); ``perm`` applies a column permutation
        first (the random-permutation control of the truncation sweep).
        """
        zxs = self._embed(model_x, self.loader.sketch_features)
        zys = self._embed(model_y, self.loader.photo_features)
        if perm is not None:
            zxs, zys = zxs[:, perm], zys[:, perm]
        if trunc_dim is not None:
            if trunc_dim >= 0:
                zxs, zys = zxs[:, :trunc_dim], zys[:, :trunc_dim]
            else:
                zxs, zys = zxs[:, trunc_dim:], zys[:, trunc_dim:]
        rel_K, idx_K = get_retrievals(zxs, zys, self.loader.sketch_classes,
                                      self.loader.photo_classes,
                                      K=self.n_retrievals, metric=self.metric,
                                      device=self.device)
        p_at_k = precision_at_k(rel_K)
        aps = np.zeros(1)
        if return_map_all:
            rel_all, _ = get_retrievals(zxs, zys, self.loader.sketch_classes,
                                        self.loader.photo_classes,
                                        metric=self.metric, device=self.device)
            aps = average_precisions(rel_all, self.n_classes_items, ver=ap_ver)
        self._last_retrievals = (rel_K, idx_K)
        return p_at_k, aps

    def save_retrievals(self, log_dir: str, n_queries: int = 20,
                        n_per_query: int = 20, tag: str = ""):
        """Write the top retrieved items per query (relevances, classes and,
        where the loader has them, paths) to ``retrievals<tag>.npz``.
        Call after :meth:`evaluate`."""
        rel_K, idx_K = self._last_retrievals
        sel = np.arange(min(n_queries, idx_K.shape[0]))
        k = min(n_per_query, idx_K.shape[1])
        payload = {
            "relevances": rel_K[sel, :k],
            "retrieved_classes": np.asarray(
                self.loader.photo_classes)[idx_K[sel, :k]],
            "query_classes": np.asarray(self.loader.sketch_classes)[sel],
        }
        if hasattr(self.loader, "photo_paths"):
            payload["retrieved_paths"] = np.asarray(
                self.loader.photo_paths)[idx_K[sel, :k]]
            payload["query_paths"] = np.asarray(
                self.loader.sketch_paths)[sel]
        os.makedirs(log_dir, exist_ok=True)
        out = os.path.join(log_dir, f"retrievals{tag}.npz")
        np.savez_compressed(out, **payload)
        return out
