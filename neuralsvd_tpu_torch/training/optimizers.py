"""Optimizers and schedules, written out as functional ``init``/``update``.

Port of ``neuralsvd_tpu/training/optimizers.py``: ``torch_rmsprop``
(:26-50), ``cosine_annealing`` (:59), ``warmup_cosine_schedule``
(:70-82), ``reject_spikes`` (:91), ``assert_mode_axis_unambiguous``
(:130), ``per_mode_lr`` (:158), ``lars`` (:190) and ``build_optimizer``
(:198-245) for every name it takes: "rmsprop", "adam", "adamw", "sgd" and
"lars".  RMSprop has the update order of ``torch.optim.RMSprop``:
    v <- alpha*v + (1-alpha)*g²;  update = -lr · g / (sqrt(v) + eps)
(eps outside the sqrt), with optional momentum.  The others are optax
chains: "sgd" is ``add_decayed_weights`` -> ``trace`` ->
-lr·schedule(count); "adam" is ``scale_by_adam`` (eps 1e-7) ->
-lr·schedule(count); "adamw" is ``scale_by_adam`` ->
``add_decayed_weights`` (the decay after Adam's scaling) ->
-lr·schedule(count); "lars" is ``add_decayed_weights`` ->
``scale_by_trust_ratio`` (0.001) -> ``trace(momentum)`` ->
-lr·schedule(count).

Every update is written out over dicts of tensors, like the optax
transformations it ports, so a train step can keep the old state where a
step is skipped without a host sync (``select_state``): schedule counts
are device tensors and are kept too, as the JAX step keeps every array
leaf of its optimizer state.  Schedules and ``reject_spikes`` are
functions of those device counts and read nothing on the host, so an
update may be captured in a CUDA graph.

On a tp mesh a rank holds only its modes' slices of the per-mode
parameters, their gradients and moments (``shards``, a
``parallel.mesh.ModeShards``): the reductions that cross those slices,
the global norm of ``grad_clip`` and ``reject_spikes`` and LARS's per-leaf
norms, sum the slices' squares over the tp group (one all-reduce each), and
``per_mode_lr`` scales a slice by its modes' factors.  So every rank of
the group takes the one-process values, and the same skip decisions.

The fused route.  ``build_optimizer`` marks the chains that one hand-written
CUDA pass computes (``Optimizer.fused``, a ``FusedRule``): RMSprop without
momentum, and SGD with momentum and without weight decay, each at a
constant lr or on a schedule, without ``reject_spikes``.  On CUDA tensors
off a tp mesh the train steps (``make_train_step``,
``make_cdk_train_step``) take it for those chains (``fused_rule``): one
launch for the gradient norm, the finite test and the clip scale, one for
the clip, the rule, -lr·u, p + u, the kept state of a skipped step and the
EMA (``fused_update``, ``ops/cuda_update.py``), each element read and
written once, in the plain route's f32 arithmetic and order.  Every other
chain (Adam, AdamW, LARS, RMSprop with momentum, ``reject_spikes``,
``per_mode_lr`` chained by a caller, a tp mesh) and every CPU step keeps
the plain route below, which is also the fused pass's test oracle.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from neuralsvd_tpu_torch.ops.cuda_update import apply_update
from neuralsvd_tpu_torch.parallel.collectives import psum


class TorchRMSpropState(NamedTuple):
    nu: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]


class TorchRMSprop(NamedTuple):
    init: Callable
    update: Callable


def torch_rmsprop(learning_rate: float, alpha: float = 0.999,
                  eps: float = 1e-10, momentum: float = 0.0) -> TorchRMSprop:
    """RMSprop at a constant ``learning_rate``; a scheduled RMSprop is this
    at 1.0 chained with the schedule (``_build_base``), as the JAX
    package's ``torch_rmsprop(schedule)`` chains ``scale_by_schedule``."""

    def init(params):
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        buf = ({k: torch.zeros_like(p) for k, p in params.items()}
               if momentum > 0 else {})
        return TorchRMSpropState(nu=zeros, momentum=buf)

    def update(grads, state: TorchRMSpropState, params=None):
        nu = {k: alpha * state.nu[k] + (1 - alpha) * g * g
              for k, g in grads.items()}
        scaled = {k: g / (torch.sqrt(nu[k]) + eps) for k, g in grads.items()}
        if momentum > 0:
            buf = {k: momentum * state.momentum[k] + s
                   for k, s in scaled.items()}
            out = buf
        else:
            buf = state.momentum
            out = scaled
        updates = {k: -learning_rate * u for k, u in out.items()}
        return updates, TorchRMSpropState(nu=nu, momentum=buf)

    return TorchRMSprop(init, update)


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def _whole_sq_norms(slices, group) -> list:
    """The squared norms of the whole tensors whose slices this rank holds
    (each slice's squares summed over ``group`` in one all-reduce)."""
    if not slices:
        return []
    return list(psum(torch.stack([torch.sum(torch.square(t)) for t in slices]), group))


def grad_norm(grads: dict, shards=None) -> torch.Tensor:
    """The global norm of the gradient dict ``grads``; on a tp mesh
    (``shards``) of the whole gradient, the per-mode slices' squares
    summed over the group, equal on every rank."""
    if shards is None:
        return global_norm(grads.values())
    sq = _whole_sq_norms([g for k, g in grads.items() if k in shards.axes], shards.group)
    sq += [torch.sum(torch.square(g)) for k, g in grads.items() if k not in shards.axes]
    return torch.sqrt(torch.sum(torch.stack(sq)))


class FusedRule(NamedTuple):
    """The update the fused CUDA pass computes for a chain
    (``ops/cuda_update.py``): ``kind`` "rmsprop" (decay α, ``eps``) or
    "trace" (momentum β = ``decay``), at ``lr``, a constant or a
    ``schedule(count)``; ``moments(state)`` and ``count(state)`` find ν or m
    and the schedule's count (None at a constant lr) in the chain's state."""
    kind: str
    decay: float
    eps: float
    lr: Union[float, Callable]
    moments: Callable
    count: Callable


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)
    fused: Optional[FusedRule] = None  # set by build_optimizer (module docstring)


def cosine_annealing(base_lr: float, num_iters: int, eta_min: float = 0.0):
    """torch CosineAnnealingLR, lr(t) = eta_min + (lr0 - eta_min)(1 + cos(πt/T))/2
    with t clipped at T; ``step`` a device tensor, the result float32."""

    def schedule(step):
        t = torch.clamp(torch.as_tensor(step), max=num_iters).to(torch.float32)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + torch.cos(torch.pi * t / num_iters))

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_lr: float, final_lr: float,
                           warmup_steps: int, total_steps: int):
    """Linear warmup then cosine decay; ``step`` is a device tensor and the
    result a float32 tensor beside it (no host sync)."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = warmup_lr + (base_lr - warmup_lr) * step / max(warmup_steps, 1)
        decay_steps = max(total_steps - warmup_steps, 1)
        t = (step - warmup_steps) / decay_steps
        cos = final_lr + 0.5 * (base_lr - final_lr) * (1 + torch.cos(torch.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def _count(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def chain(*parts: Optimizer) -> Optimizer:
    """Apply ``parts`` in order, as ``optax.chain``; the state is a tuple."""
    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(grads, state, params=None):
        new_state = []
        for part, sub in zip(parts, state):
            grads, sub = part.update(grads, sub, params)
            new_state.append(sub)
        return grads, tuple(new_state)

    return Optimizer(init, update)


def _add_decayed_weights(weight_decay: float) -> Optimizer:
    return Optimizer(
        lambda params: (),
        lambda grads, state, params: (
            {k: g + weight_decay * params[k] for k, g in grads.items()}, state))


def _trace(decay: float) -> Optimizer:
    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, state, params=None):
        new = {k: g + decay * state[k] for k, g in grads.items()}
        return new, new

    return Optimizer(init, update)


def _scale_by_trust_ratio(trust_coefficient: float, shards=None) -> Optimizer:
    """optax's ``scale_by_trust_ratio`` (min_norm 0, eps 0): each tensor's
    update times c·‖p‖/‖u‖, or times 1 where either norm is 0; the norms
    of a tp-sharded tensor are the whole tensor's."""
    def update(grads, state, params):
        out = {}
        p_sq = u_sq = {}
        if shards is not None:
            names = [k for k in grads if k in shards.axes]
            sq = _whole_sq_norms([params[k] for k in names] + [grads[k] for k in names],
                                 shards.group)
            p_sq, u_sq = dict(zip(names, sq[:len(names)])), dict(zip(names, sq[len(names):]))
        for k, u in grads.items():
            p_norm = (torch.sqrt(p_sq[k]) if k in p_sq
                      else torch.linalg.vector_norm(params[k]))
            u_norm = torch.sqrt(u_sq[k]) if k in u_sq else torch.linalg.vector_norm(u)
            ratio = trust_coefficient * p_norm / u_norm
            zero = (p_norm == 0) | (u_norm == 0)
            out[k] = u * torch.where(zero, torch.ones_like(ratio), ratio)
        return out, state

    return Optimizer(lambda params: (), update)


def _scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-7) -> Optimizer:
    def init(params):
        return {"count": _count(params),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        count = state["count"] + 1
        c = count.to(torch.float32)
        mu_fix = 1 - torch.pow(b1, c)
        nu_fix = 1 - torch.pow(b2, c)
        updates = {k: (mu[k] / mu_fix) / (torch.sqrt(nu[k] / nu_fix) + eps)
                   for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _scale_by_lr(learning_rate) -> Optimizer:
    """-lr·u, with lr a constant or ``schedule(count)`` (count a device
    tensor incremented after use, as optax's ``scale_by_schedule``)."""
    if not callable(learning_rate):
        return Optimizer(
            lambda params: (),
            lambda grads, state, params: (
                {k: -learning_rate * g for k, g in grads.items()}, state))

    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        step_size = -learning_rate(state["count"])
        return ({k: step_size * g for k, g in grads.items()},
                {"count": state["count"] + 1})

    return Optimizer(init, update)


def reject_spikes(factor: float = 25.0, decay: float = 0.99,
                  warmup: int = 100, shards=None) -> Optimizer:
    """Zero the update whose global gradient norm exceeds ``factor`` x its
    running EMA (chained before the optimizer, so a spike neither steps nor
    enters the second moments).  The first ``warmup`` steps always pass;
    rejected steps leave the EMA alone.  State: {"gnorm_ema", "count",
    "rejected"}, device tensors; ``shards``: the norm of a tp mesh's whole
    gradient (``grad_norm``)."""
    def init(params):
        device = next(iter(params.values())).device
        return {"gnorm_ema": torch.zeros((), device=device),
                "count": _count(params), "rejected": _count(params)}

    def update(grads, state, params=None):
        gnorm = grad_norm(grads, shards)
        ok = ((state["count"] < warmup) | (gnorm <= factor * state["gnorm_ema"]))
        ok = ok & torch.isfinite(gnorm)
        ema = torch.where(
            state["count"] == 0, gnorm,
            torch.where(ok, decay * state["gnorm_ema"] + (1 - decay) * gnorm,
                        state["gnorm_ema"]))
        grads = {k: torch.where(ok, g, torch.zeros_like(g))
                 for k, g in grads.items()}
        return grads, {"gnorm_ema": ema, "count": state["count"] + 1,
                       "rejected": state["rejected"] + (~ok).to(torch.int32)}

    return Optimizer(init, update)


def assert_mode_axis_unambiguous(params, neigs: int) -> None:
    """Refuse per-mode surgery (``per_mode_lr``) unless every parameter
    leads with the mode axis, the ParallelMLP layout; a shared parameter
    whose leading size merely equals ``neigs`` would be scaled as if it
    were per-mode."""
    for name, p in params.items():
        shape = tuple(p.shape)
        if len(shape) < 1 or shape[0] != neigs:
            raise ValueError(
                f"per-mode tree surgery (tail_lr_boost / rescue) requires "
                f"every param leaf to lead with the mode axis (neigs="
                f"{neigs}); leaf {name} has shape {shape}. Shared leaves "
                f"make the shape[0]==neigs heuristic ambiguous — use "
                f"per-mode towers (parallel=True) without shared learnable "
                f"features.")


def per_mode_lr(scales, neigs: int, shards=None) -> Optimizer:
    """Scale the final updates of each eigenfunction tower by ``scales``
    (L,): every update whose leading size is ``neigs`` (chained after the
    optimizer, so it is a per-mode learning rate).  On a tp mesh
    (``shards``) every update sharded on its leading axis, whose leading
    size is the rank's share of the modes, by the slice of ``scales`` of
    those modes."""
    scales = torch.as_tensor(np.asarray(scales, dtype=np.float32))
    if tuple(scales.shape) != (neigs,):
        raise ValueError(f"scales must have shape ({neigs},)")
    if shards is not None:
        lo, hi = shards.range
        scales, neigs = scales[lo:hi], hi - lo
    # made once a device: a copy inside a captured step would be a
    # host-to-device copy during capture
    cache: Dict[torch.device, torch.Tensor] = {}

    def update(grads, state, params=None):
        out = {}
        for k, u in grads.items():
            per_mode = (shards.axes.get(k) == 0 if shards is not None
                        else u.ndim >= 1 and u.shape[0] == neigs)
            if per_mode:
                if u.device not in cache:
                    cache[u.device] = scales.to(u.device)
                u = u * cache[u.device].reshape((neigs,) + (1,) * (u.ndim - 1))
            out[k] = u
        return out, state

    return Optimizer(lambda params: (), update)


def lars(learning_rate, weight_decay: float = 0.0, momentum: float = 0.9,
         trust_coefficient: float = 0.001, shards=None) -> Optimizer:
    """Layer-wise adaptive rate scaling, as the JAX package chains it."""
    return chain(_add_decayed_weights(weight_decay),
                 _scale_by_trust_ratio(trust_coefficient, shards), _trace(momentum),
                 _scale_by_lr(learning_rate))


def build_optimizer(name: str, learning_rate: float, momentum: float = 0.0,
                    weight_decay: float = 0.0, rmsprop_decay: float = 0.999,
                    adam_eps: float = 1e-7,
                    lr_schedule: Optional[Callable] = None,
                    spike_reject_factor: float = 0.0, shards=None) -> Optimizer:
    """"sgd", "adam", "adamw", "lars" or "rmsprop"; ``lr_schedule(count)`` replaces the
    constant ``learning_rate`` where given; ``spike_reject_factor`` > 0
    chains ``reject_spikes`` before it; ``shards``: a tp mesh's
    ``ModeShards`` (module docstring)."""
    base = _build_base(name, learning_rate, momentum, weight_decay,
                       rmsprop_decay, adam_eps, lr_schedule, shards)
    if spike_reject_factor > 0:
        return chain(reject_spikes(spike_reject_factor, shards=shards), base)
    return base


def _build_base(name, learning_rate, momentum, weight_decay, rmsprop_decay,
                adam_eps, lr_schedule, shards=None) -> Optimizer:
    lr = lr_schedule if lr_schedule is not None else learning_rate
    if name == "rmsprop":
        rms = torch_rmsprop(1.0 if callable(lr) else lr, alpha=rmsprop_decay,
                            eps=1e-10, momentum=momentum)
        core = Optimizer(rms.init, rms.update)
        if not callable(lr):
            opt, moments, count = core, lambda s: s.nu, lambda s: None
        else:
            # torch_rmsprop(1.0) gives -u; scale it by +lr(count)
            opt = chain(core, _scale_by_lr(lambda c: -lr(c)))
            moments, count = lambda s: s[0].nu, lambda s: s[1]["count"]
        if momentum > 0:
            return opt
        return opt._replace(fused=FusedRule("rmsprop", rmsprop_decay, 1e-10, lr, moments, count))
    if name == "adam":
        return chain(_scale_by_adam(eps=adam_eps), _scale_by_lr(lr))
    if name == "adamw":
        return chain(_scale_by_adam(eps=adam_eps),
                     _add_decayed_weights(weight_decay), _scale_by_lr(lr))
    if name == "lars":
        return lars(lr, weight_decay=weight_decay, momentum=momentum, shards=shards)
    if name == "sgd":
        parts = []
        if weight_decay:
            parts.append(_add_decayed_weights(weight_decay))
        if momentum:
            parts.append(_trace(momentum))
        parts.append(_scale_by_lr(lr))
        opt = chain(*parts)
        if not momentum or weight_decay:
            return opt
        count = (lambda s: s[1]["count"]) if callable(lr) else (lambda s: None)
        return opt._replace(fused=FusedRule("trace", momentum, 0.0, lr, lambda s: s[0], count))
    raise NotImplementedError(name)


def select_state(keep_new, new, old):
    """``new`` where ``keep_new`` (a device bool) else ``old``, for every
    tensor of an optimizer state built from tuples, NamedTuples and dicts;
    non-tensor leaves come from ``new``."""
    if isinstance(new, torch.Tensor):
        return torch.where(keep_new, new, old)
    if isinstance(new, dict):
        return {k: select_state(keep_new, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        items = (select_state(keep_new, n, o) for n, o in zip(new, old))
        return type(new)(*items) if hasattr(new, "_fields") else tuple(items)
    return new


def fused_rule(optimizer: Optimizer, params: dict, shards=None) -> Optional[FusedRule]:
    """``optimizer.fused`` where a step takes the fused CUDA update: a
    chain ``build_optimizer`` marked, no tp mesh (``shards``: the fused
    norm is one process's) and the parameters on CUDA; else None (the
    plain route, also for any other object with ``init`` and ``update``,
    such as a bare ``torch_rmsprop``).  The fused pass raises on
    parameters that are not contiguous float32 (``cuda_update``)."""
    rule = getattr(optimizer, "fused", None)
    if rule is None or shards is not None or not _on_card(params):
        return None
    return rule


def _on_card(params: dict) -> bool:
    return all(p.is_cuda for p in params.values())


def fused_update(rule: FusedRule, status, grads: dict, params: dict, opt_state,
                 ema=None) -> None:
    """A step's update by the fused CUDA pass (``cuda_update.apply_update``):
    what ``optimizer.update``, ``p + u`` and ``select_state`` of the plain
    route give, written in place into ``params`` and ``opt_state``.
    ``status``: ``cuda_update.grad_status`` of ``grads``; ``ema``:
    (ema params, decay, step counter) or None."""
    count = rule.count(opt_state)
    lr = rule.lr(count) if callable(rule.lr) else rule.lr
    if isinstance(lr, torch.Tensor):
        lr = lr.to(torch.float32)
    moments = rule.moments(opt_state)
    emas, ema_decay, step = ema if ema is not None else (None, 0.0, None)
    names = list(params)
    apply_update(status, [grads[k] for k in names], [params[k] for k in names],
                 [moments[k] for k in names], None if emas is None else [emas[k] for k in names],
                 rule=rule.kind, decay=rule.decay, eps=rule.eps, lr=lr, count=count, step=step,
                 ema_decay=ema_decay)
