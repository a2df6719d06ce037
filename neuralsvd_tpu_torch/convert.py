"""Carry JAX parameters into the port's modules.

``params_from_jax`` maps the JAX package's wavefunction tree onto the
state dict of ``models.wavefunctions.Wavefunction``: the ParallelMLP's
``{"base": {"ws": [(L, h, d), ...], "bs": [(L, h, 1), ...],
"feature_map": {}}}`` or the shared trunk's ``{"base": {"layers": [{"w":
(in, out), "b": (out,), "g": (out,)}, ...], "feature_map": {}}}`` (``b``
absent without biases, ``g`` present under weight normalization), with the exponential
mask's ``{"mask": {"scales": (L,)}}`` where there is one;
``hetero_params_from_jax`` maps the
two-tower tree ``{"x": {"layers": [{"w": (in, out), "b": (out,)}, ...]},
"y": ..., "head_x": ..., "head_y": ...}`` (heads where the network has
``num_classes``) onto that of ``models.two_tower.HeteroNetwork`` (the same
(in, out) layout, so no transpose); ``siam_params_from_jax`` maps
``make_siam_network``'s params and state (``backbone``, ``projector``,
``scales_param``; ``l2norm``, ``initialized``) onto ``SiamNetwork``'s
parameters and buffers; ``resnet_state_from_jax`` maps a ResNet's params
and BatchNorm state onto the state dict of ``models.resnet``'s modules
(conv weights HWIO -> OIHW, the running statistics as buffers);
``probe_params_from_jax`` maps a multi-head probe's head tree onto
``models.probe.MultiHeadProbe``'s ``heads``; ``method_state_from_jax`` carries a
method's state (NeuralEF's ``norm_biased``, ``norm_unbiased`` (1, L) and
the bool ``initialized``; SpIN's ``sigma_avg``, ``chol`` and the nested
``j_avg``, flattened to the port's parameter names, per-mode leaves in
the compact layout of ``methods/spin.py``; SpINx's ``weights``).  Leaves
are already numpy arrays; so both packages compute the same function in
the tests.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """-> {"base.ws.0": tensor, ..., "base.bs.0": tensor, ...,
    "mask.scales": tensor} (float32)."""
    base = tree["base"]
    if base.get("feature_map"):
        raise ValueError("feature maps carry no parameters in either package")
    out = {}
    for group in ("ws", "bs"):
        for i, leaf in enumerate(base.get(group, [])):
            out[f"base.{group}.{i}"] = torch.tensor(
                np.asarray(leaf, dtype=np.float32))
    for i, layer in enumerate(base.get("layers", [])):
        if set(layer) - {"w", "b", "g"}:
            raise ValueError(f"unknown leaves {sorted(set(layer) - {'w', 'b', 'g'})} "
                             "in a shared-trunk layer")
        for name, leaf in layer.items():
            out[f"base.layers.{i}.{name}"] = torch.tensor(
                np.asarray(leaf, dtype=np.float32))
    if "mask" in tree:
        out["mask.scales"] = torch.tensor(
            np.asarray(tree["mask"]["scales"], dtype=np.float32))
    return out


def _f32(leaf) -> torch.Tensor:
    return torch.tensor(np.asarray(leaf, dtype=np.float32))


def hetero_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """-> {"x.layers.0.w": tensor, "x.layers.0.b": tensor, ...,
    "head_x.layers.0.w": ...} (float32)."""
    extra = set(tree) - {"x", "y", "head_x", "head_y"}
    if extra:
        raise ValueError(f"unknown two-tower parameters {sorted(extra)}")
    out = {}
    for side in [k for k in ("x", "y", "head_x", "head_y") if k in tree]:
        for i, layer in enumerate(tree[side]["layers"]):
            if set(layer) - {"w", "b"}:
                raise ValueError(
                    "a two-tower layer holds only w and b: the JAX package's "
                    "make_hetero_network has no weight normalization")
            for name, leaf in layer.items():
                out[f"{side}.layers.{i}.{name}"] = torch.tensor(
                    np.asarray(leaf, dtype=np.float32))
    return out


def siam_params_from_jax(params, state=None) -> Dict[str, torch.Tensor]:
    """-> {"backbone.layers.0.w": ..., "projector.layers.0.w": ...,
    "scales_param": ..., "l2norm": ..., "initialized": ...}: a state dict
    of ``SiamNetwork`` (the buffers where ``state`` is given)."""
    out = {name: _f32(leaf) for name, leaf in _named_leaves(params)}
    if state is not None:
        out["l2norm"] = _f32(state["l2norm"])
        out["initialized"] = torch.tensor(bool(np.asarray(state["initialized"])))
    return out


def resnet_state_from_jax(params, state, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A ResNet's (params, BatchNorm state) -> the state dict of
    ``models.resnet.ResNet`` (or ``LinearProbe`` with ``state={}``) in
    ``dtype``: conv weights (kh, kw, in, out) -> (out, in, kh, kw), the
    head's (in, out) kept, the running ``mean``/``var`` as buffers."""
    out = {}
    for name, leaf in _named_leaves(params):
        t = torch.tensor(np.asarray(leaf), dtype=dtype)
        out[name] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
    for name, leaf in _named_leaves(state):
        out[name] = torch.tensor(np.asarray(leaf), dtype=dtype)
    return out


def probe_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A multi-head probe's {head name: {"layers": [...]}} -> the state dict
    of ``MultiHeadProbe`` ({"heads.<name>.layers.0.w": ...})."""
    return {f"heads.{name}": _f32(leaf) for name, leaf in _named_leaves(tree)}


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) of a nest of dicts and lists: the port's
    parameter names for a JAX parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _compact_j(name, dense: np.ndarray) -> np.ndarray:
    """(L, L, L, *rest) -> its diagonal blocks (L, L, *rest), [m, s] =
    dense[m, s, s]; raises where a block off the diagonal is nonzero."""
    L = dense.shape[0]
    off = ~np.eye(L, dtype=bool)
    if np.any(dense[:, off]):
        raise ValueError(f"j_avg[{name}] has nonzero blocks off the diagonal: "
                         "it is not a per-mode parameter")
    return np.moveaxis(np.diagonal(dense, axis1=1, axis2=2), -1, 1)


def method_state_from_jax(state, per_mode=(), dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A method state of numpy leaves -> {name: tensor}: bool leaves stay
    bool, the rest become ``dtype`` ({} stays {}).  SpIN's ``j_avg`` becomes
    {parameter name: tensor}, the names in ``per_mode`` (the model's
    ``per_mode_parameters()``) compact."""
    def tensor(a):
        a = np.asarray(a)
        return torch.tensor(a) if a.dtype == np.bool_ else torch.tensor(a, dtype=dtype)

    out = {}
    for name, leaf in state.items():
        if name == "j_avg":
            out[name] = {k: tensor(_compact_j(k, np.asarray(j)) if k in per_mode else j)
                         for k, j in _named_leaves(leaf)}
        else:
            out[name] = tensor(leaf)
    return out
