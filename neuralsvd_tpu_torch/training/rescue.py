"""Dead/duplicate-mode rescue: eigval-sorted reordering + tail re-init.

Port of ``neuralsvd_tpu/training/rescue.py``.  A near-zero-amplitude mode
parked on an already-occupied eigendirection is loss-free under the
norm-invariant NestedLoRA objective, so the driver repairs it between
blocks, on the host: diagnose dead and duplicate modes from the eval's
accumulators (``methods.spectrum.mode_health``), permute the modes so the
healthy ones come first in Rayleigh-descending order, and re-initialize
the exiled tail slots, either as perturbed clones of the smallest healthy
modes (which inherit their optimizer moments) or from a fresh draw (with
zeroed moments), then match their amplitudes to their peers' and set
their EMA to the new parameters.

The JAX package builds new trees; here every change is written in place
(``copy_``, ``index_copy_``, ``zero_`` under ``torch.no_grad()``) into the
tensors of the ``TrainState``, whose addresses a captured CUDA graph
reads: ``state_pointers(ts)`` is the same before and after a rescue.

Per-mode state is recognised by shape, as in JAX: every tensor whose
leading axis equals the mode count L (the ParallelMLP's ``base.ws.<i>``
(L, h, d) and ``base.bs.<i>`` (L, h, 1), the exponential mask's
``mask.scales`` (L,), their RMSprop moments and EMA copies).  Other
tensors (schedule counts and other scalars) pass through untouched; the
caller checks with ``assert_mode_axis_unambiguous`` that no shared
parameter leads with L.

Random numbers come from a ``torch.Generator`` on the CPU and the draws
are moved to the state's device, so CPU and GPU runs draw alike.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from neuralsvd_tpu_torch.methods.spectrum import mode_health
from neuralsvd_tpu_torch.training.train_state import TrainState


def named_leaves(tree, path=""):
    """(name, tensor) of every tensor in a nest of dicts, lists, tuples
    and NamedTuples, in a fixed order; names join keys and indices by '.'."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(fields, tree):
            yield from named_leaves(v, f"{path}.{k}" if path else str(k))


def _mode_leaves(tree, neigs: int):
    return [(name, leaf) for name, leaf in named_leaves(tree)
            if leaf.ndim >= 1 and leaf.shape[0] == neigs]


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


def tree_permute_modes(tree, perm) -> None:
    """Permute axis 0 of every tensor whose leading size is len(perm), in
    place; other tensors are left as they are."""
    with torch.no_grad():
        for _, leaf in _mode_leaves(tree, len(perm)):
            leaf.copy_(leaf.index_select(0, _index(perm, leaf.device)))


def _tree_splice_tail(old_tree, fresh_tree, neigs: int, n_tail: int) -> None:
    """Copy the last ``n_tail`` mode slices of ``fresh_tree`` into those
    of ``old_tree``, matching tensors by name."""
    fresh = dict(named_leaves(fresh_tree))
    with torch.no_grad():
        for name, leaf in _mode_leaves(old_tree, neigs):
            leaf[neigs - n_tail:] = fresh[name][neigs - n_tail:].to(leaf.device)


def _tree_clone_slots(tree, neigs: int, src_idx, dst_idx) -> None:
    """Copy mode slices ``src_idx`` -> ``dst_idx`` on every mode tensor."""
    with torch.no_grad():
        for _, leaf in _mode_leaves(tree, neigs):
            src, dst = _index(src_idx, leaf.device), _index(dst_idx, leaf.device)
            leaf.index_copy_(0, dst, leaf.index_select(0, src))


def _tree_zero_tail(tree, neigs: int, n_tail: int) -> None:
    with torch.no_grad():
        for _, leaf in _mode_leaves(tree, neigs):
            leaf[neigs - n_tail:].zero_()


def rescue_plan(health):
    """Permutation placing healthy modes first (Rayleigh descending).

    Returns (perm, n_spurious); perm is None when every mode is healthy.
    Spurious modes (duplicates + dead) land in the tail slots, ordered by
    norm so repeat diagnoses are stable.
    """
    healthy = np.asarray(health["healthy"])
    if healthy.all():
        return None, 0
    rayleigh = np.asarray(health["rayleigh"])
    good = np.nonzero(healthy)[0]
    bad = np.nonzero(~healthy)[0]
    good = good[np.argsort(rayleigh[good])[::-1]]
    bad = bad[np.argsort(np.asarray(health["norms"])[bad])[::-1]]
    return np.concatenate([good, bad]), len(bad)


def clone_perturb_tail(params, neigs: int, src_idx, dst_idx,
                       generator: Optional[torch.Generator] = None,
                       noise: float = 0.25,
                       draw: Optional[Callable] = None) -> None:
    """Write perturbed clones of healthy modes into the tail slots.

    For every mode tensor of ``params`` (name -> tensor), slot
    ``dst_idx[k]`` becomes ``leaf[src_idx[k]] + noise · rms · ε``, rms
    the root mean square of the source slice and ε standard normal:
    ``draw(name, shape)`` where given (tests pass JAX's draws by name),
    else ``torch.randn`` from ``generator`` on the CPU, moved to the
    leaf's device.  A clone of a converged small-eigenvalue mode starts
    with a positive Rayleigh quotient; deflation against its source then
    strips the duplicated component.
    """
    with torch.no_grad():
        for name, leaf in _mode_leaves(params, neigs):
            src = _index(src_idx, leaf.device)
            dst = _index(dst_idx, leaf.device)
            s = leaf.index_select(0, src)
            if not s.is_floating_point():
                leaf.index_copy_(0, dst, s)
                continue
            rms = torch.sqrt(torch.mean(s * s, dim=tuple(range(1, s.ndim)),
                                        keepdim=True) + 1e-30)
            eps = (draw(name, tuple(s.shape)) if draw is not None
                   else torch.randn(tuple(s.shape), generator=generator))
            eps = torch.as_tensor(eps, dtype=s.dtype).to(leaf.device)
            leaf.index_copy_(0, dst, s + noise * rms * eps)


def rescue_modes(ts: TrainState, init_fn: Callable, generator, cov, quad,
                 neigs: int, corr_thresh: float = 0.5,
                 dead_rel: float = 1e-3,
                 measure_norms: Optional[Callable] = None,
                 scale_fn: Optional[Callable] = None,
                 amplitude_frac: float = 0.5,
                 clone_healthy_tail: bool = False,
                 clone_noise: float = 0.25,
                 grace_slots=None,
                 draw: Optional[Callable] = None):
    """Diagnose and repair a collapsed TrainState, in place.

    Returns (ts, info); ``info["n_spurious"] == 0`` means nothing changed.
    ``init_fn(generator)`` returns fresh parameters (name -> tensor) for
    the fresh-init path; ``generator`` also draws the clones' noise
    (``draw``: see ``clone_perturb_tail``).

    Amplitude matching (both hooks given): after the splice,
    ``measure_norms(params) -> (L,)`` batch norms are taken and each tail
    mode is rescaled in place by ``scale_fn(params, tail_idx, factors)``
    to ``amplitude_frac`` x its clone source's norm (clone path) or x the
    smallest healthy norm (fresh path).  ``grace_slots``: slots rescued at
    the previous event, exempt from the duplicate criterion (a separating
    clone still correlates with its source) but not from being dead.
    With every mode spurious the clone path has no source and falls back
    to fresh draws.
    """
    health = mode_health(cov, quad, corr_thresh=corr_thresh, dead_rel=dead_rel)
    if grace_slots is not None and len(grace_slots):
        g = np.asarray(grace_slots, dtype=np.int64)
        keep = (health["duplicate_of"][g] >= 0) & ~health["dead"][g]
        health = dict(health)
        health["duplicate_of"] = health["duplicate_of"].copy()
        health["duplicate_of"][g[keep]] = -1
        health["healthy"] = (health["duplicate_of"] < 0) & ~health["dead"]
    perm, n_bad = rescue_plan(health)
    info = {"health": health, "n_spurious": n_bad}
    if n_bad == 0:
        return ts, info
    for tree in (ts.params, ts.ema_params, ts.opt_state):
        tree_permute_modes(tree, perm)
    tail_idx = np.arange(neigs - n_bad, neigs)
    clone_healthy_tail = clone_healthy_tail and n_bad < neigs
    if clone_healthy_tail:
        # the K smallest-eigenvalue healthy modes, cycled over the tail
        n_src = min(max(n_bad, 2), neigs - n_bad, 4)
        srcs = np.array([neigs - n_bad - 1 - (k % n_src) for k in range(n_bad)])
        clone_perturb_tail(ts.params, neigs, srcs, tail_idx, generator,
                           noise=clone_noise, draw=draw)
        # clones inherit the source's optimizer moments
        _tree_clone_slots(ts.opt_state, neigs, srcs, tail_idx)
        info["clone_sources"] = srcs
    else:
        _tree_splice_tail(ts.params, init_fn(generator), neigs, n_bad)
        _tree_zero_tail(ts.opt_state, neigs, n_bad)
    if measure_norms is not None and scale_fn is not None and n_bad < neigs:
        norms_now = np.asarray(measure_norms(ts.params))
        if clone_healthy_tail:
            target = amplitude_frac * np.maximum(
                norms_now[info["clone_sources"]], 1e-30)
        else:
            target = amplitude_frac * max(
                float(norms_now[:neigs - n_bad].min()), 1e-30)
        factors = np.sqrt(target / np.maximum(norms_now[tail_idx], 1e-30))
        scale_fn(ts.params, tail_idx, factors)
        info["amplitude_factors"] = factors
    info.setdefault("amplitude_factors", np.ones(n_bad))
    # tail EMA := the (rescaled) new params; the healthy EMA is kept
    _tree_splice_tail(ts.ema_params, ts.params, neigs, n_bad)
    info["perm"] = perm
    info["tail_slots"] = tail_idx
    return ts, info
