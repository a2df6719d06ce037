"""Probes over frozen pretrained embeddings.

Port of ``neuralsvd_tpu/models/probe.py``: one classifier head per view
of a frozen encoder, ``rep`` (the backbone representation), ``emb`` (the
projected embedding) and ``trunc(k)`` (its first k coordinates, or its
last |k| for k < 0), linear or MLP heads, with optional division of the
embedding by the square roots of the eigenvalues and a spectrum-sorted
coordinate order.

``make_multihead_probe`` returns a ``MultiHeadProbe`` module: the encoder
is a callable held outside the module's parameters, its outputs are
detached (the reference's ``freeze_model=True``), so only the heads'
parameters are the module's and train.  Head parameters are
``heads.<name>.layers.<i>.{w, b}`` with weights (in, out), the JAX tree
``{<name>: {"layers": [...]}}``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from neuralsvd_tpu_torch.models.mlp import MLP


def register_spectrum(spectrum) -> dict:
    """The spectrum record ``forward`` takes for ``normalize``/``sort``:
    the eigenvalues without the first (constant) mode, and their order
    from the largest."""
    spectrum = np.asarray(spectrum)[1:]
    return {"spectrum": torch.as_tensor(spectrum, dtype=torch.float32),
            "sort_indices": np.argsort(spectrum)[::-1].copy()}


class MultiHeadProbe(nn.Module):
    """``forward(x, spectrum_record=None, normalize=False)`` -> {head name:
    logits}; ``embed_fn(x) -> (rep, emb)`` is the frozen encoder."""

    def __init__(self, embed_fn: Callable, rep_dim: int, emb_dim: int,
                 num_classes: int, trunc_dims: Sequence[int] = (),
                 hidden_dims: Optional[Sequence[int]] = None, sort: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # kept out of the module tree: an encoder module's parameters stay
        # out of the probe's
        object.__setattr__(self, "embed_fn", embed_fn)
        self.trunc_dims = tuple(int(d) for d in trunc_dims) if trunc_dims else (emb_dim,)
        self.sort = sort
        specs = {"rep": rep_dim, "emb": emb_dim}
        for dim in self.trunc_dims:
            specs[f"trunc({dim})"] = abs(dim)
        self.heads = nn.ModuleDict({
            name: MLP([in_dim] + list(hidden_dims or []) + [num_classes], "relu",
                      generator=generator)
            for name, in_dim in specs.items()})

    def forward(self, x, spectrum_record=None, normalize: bool = False):
        rep, emb = self.embed_fn(x)
        rep, emb = rep.detach(), emb.detach()
        if normalize:
            emb = emb / torch.sqrt(spectrum_record["spectrum"].to(emb.device))[None, :]
        if self.sort and spectrum_record is not None:
            emb = emb[..., torch.as_tensor(spectrum_record["sort_indices"], device=emb.device)]
        logits = {"rep": self.heads["rep"](rep), "emb": self.heads["emb"](emb)}
        for dim in self.trunc_dims:
            sliced = emb[:, :dim] if dim > 0 else emb[:, dim:]
            logits[f"trunc({dim})"] = self.heads[f"trunc({dim})"](sliced)
        return logits


def make_multihead_probe(embed_fn: Callable, rep_dim: int, emb_dim: int,
                         num_classes: int, trunc_dims: Sequence[int] = (),
                         hidden_dims: Optional[Sequence[int]] = None,
                         sort: bool = False,
                         generator: Optional[torch.Generator] = None) -> MultiHeadProbe:
    """The probe module (on the CPU; move it with ``.to``), its heads drawn
    from ``generator``; pair it with ``register_spectrum``."""
    return MultiHeadProbe(embed_fn, rep_dim, emb_dim, num_classes, trunc_dims,
                          hidden_dims, sort, generator)
