"""Weighted kNN monitor for representation quality.

Port of ``neuralsvd_tpu/eval/knn.py``: the InstDisc-style cosine-weighted
kNN.  On the device (default: the GPU): the query batch's cosine scores
against the L2-normalized bank (one ``torch.matmul``), ``torch.topk``, and
the class scores Σ exp(sim/T) over the k neighbours of each class; the
JAX package computes them outside any Pallas kernel too (``@``,
``lax.top_k``).  ``torch.topk`` and ``lax.top_k`` may order tied scores
differently.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from neuralsvd_tpu_torch.device import resolve_device


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


def knn_predict(features, bank_features, bank_labels, num_classes: int,
                k: int = 200, temperature: float = 0.1, batch: int = 4096,
                device=None) -> np.ndarray:
    """Labels of ``features`` (Q, D) by a vote of their k nearest (cosine)
    rows of the labelled bank (N, D), each weighted exp(sim/T)."""
    dev = resolve_device(device)
    bank = _normalized(torch.as_tensor(np.asarray(bank_features, np.float32), device=dev))
    labels = torch.as_tensor(np.asarray(bank_labels, np.int64), device=dev)
    features = np.asarray(features, np.float32)
    preds = []
    with torch.no_grad():
        for i in range(0, len(features), batch):
            q = _normalized(torch.as_tensor(features[i:i + batch], device=dev))
            sim_k, idx_k = torch.topk(q @ bank.T, k, dim=1)
            scores = torch.zeros(q.shape[0], num_classes, device=dev)
            scores.scatter_add_(1, labels[idx_k], torch.exp(sim_k / temperature))
            preds.append(torch.argmax(scores, dim=1).cpu().numpy())
    return np.concatenate(preds) if preds else np.zeros(0, np.int64)


def knn_monitor(embed_fn: Callable, bank_data, bank_labels, test_data, test_labels,
                num_classes: int, k: int = 200, temperature: float = 0.1,
                batch: int = 1024, device=None) -> float:
    """Embed both sets with ``embed_fn`` (tensors on ``device`` in batches
    of ``batch``) and return the kNN top-1 accuracy."""
    dev = resolve_device(device)

    def embed(data):
        data = np.asarray(data, np.float32)
        out = []
        with torch.no_grad():
            for i in range(0, len(data), batch):
                out.append(embed_fn(torch.as_tensor(data[i:i + batch], device=dev))
                           .float().cpu().numpy())
        return np.concatenate(out)

    preds = knn_predict(embed(test_data), embed(bank_data), bank_labels, num_classes,
                        k, temperature, device=dev)
    return float((preds == np.asarray(test_labels)).mean())
