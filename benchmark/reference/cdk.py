"""Plain PyTorch reference of the Sketchy CDK training step.

What one step computes, from the recipe (``scripts/exps/sketchy.sh``: the
NeuralSVD paper's canonical-dependence-kernel loss on paired features,
joint nesting, a constant zeroth mode) and written here without any code of
the port:

1. Two towers, x and y, each ``512 -> 8192 -> 512``: ``h = x W0 + b0``,
   leaky ReLU of slope 0.2, ``z = h W1 + b1``; each output row is pushed
   back onto the ball of radius √μ (``z`` if ``|z| < √μ``, else
   ``√μ·z/|z|``).
2. ``f = [1, f(x)]``, ``g = [1, g(y)]`` (B, L+1).  The loss is
   ``-2·mean_b Σ_l w_l f_bl g_bl + Σ_lm M_lm Λf_lm Λg_lm`` with
   ``Λf = fᵀf/B``, ``Λg = gᵀg/B``, joint nesting of step 1: the prefix
   weights 1/L each, ``w`` their reversed cumulative sum with the constant
   mode's weight w_0 in front, ``M_lm = min(w_l, w_m)``.  The gradient
   handed to the towers is the estimator ``(2/B)·f (M⊙Λg) - (2/B)·w⊙g``
   for f and ``(2/B)·g (M⊙Λf) - (2/B)·w⊙f`` for g, the constant column
   dropped.
3. The gradient clipped to global norm c: times ``min(1, c/(‖g‖ + 1e-6))``;
   a non-finite entry skips the update (parameters and state kept).
4. SGD with momentum: ``m <- g + βm``, update ``-lr(t)·m``, lr(t) the
   cosine over the recipe's epochs, ``lr/2·(1 + cos(πt/T))`` (no warm-up),
   t the number of updates taken.

Everything runs in float32 with TF32 off.  The harness makes the weights
(``make_weights``) and the batches and hands the same to this module.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ASSUMED = {"optimizer": "sgd", "weight_decay": 0.0, "regularize_mode": "l2_ball",
           "loss": "neuralsvd", "neuralsvd.set_first_mode_const": "true",
           "neuralsvd.sequential": False, "compute_dtype": "f32",
           "warmup_epochs": 0, "warmup_lr": 0.0, "final_lr": 0.0}


def check_flags(flags: dict) -> None:
    """Raise where the configuration asks for something this reference
    does not compute."""
    for key, want in ASSUMED.items():
        got = flags.get(key, want)
        if got != want:
            raise ValueError(f"the CDK reference computes {key}={want!r}, not {got!r}")


def _dims(flags: dict, input_dim: int) -> list:
    return [input_dim] + [int(h) for h in str(flags["network_dims"]).split(",")]


def param_shapes(flags: dict, input_dim: int) -> dict:
    """{name: shape}, named as the program names them (weights (in, out))."""
    dims = _dims(flags, input_dim)
    shapes = {}
    for side in ("x", "y"):
        for i in range(len(dims) - 1):
            shapes[f"{side}.layers.{i}.w"] = (dims[i], dims[i + 1])
            shapes[f"{side}.layers.{i}.b"] = (dims[i + 1],)
    return shapes


def make_weights(flags: dict, input_dim: int, seed: int, device) -> dict:
    """The initial weights from ``seed`` on ``device``, one draw a tensor:
    U(-1/√fan_in, 1/√fan_in), torch.nn.Linear's distribution."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = _dims(flags, input_dim)
    out = {}
    for name, shape in param_shapes(flags, input_dim).items():
        bound = 1.0 / math.sqrt(dims[int(name.split(".")[2])])
        out[name] = (2 * torch.rand(shape, generator=gen, device=device) - 1) * bound
    return out


def masks(neigs: int, device):
    """(w (L+1,), M (L+1, L+1)): joint nesting of step 1, constant mode first."""
    w = np.cumsum(np.full(neigs, 1.0 / neigs)[::-1])[::-1]
    w = np.concatenate([w[:1], w]).astype(np.float32)
    w_t = torch.as_tensor(w, device=device)
    return w_t, torch.minimum(w_t[:, None], w_t[None, :])


class Problem:
    def __init__(self, flags: dict, steps_per_epoch: int, device):
        check_flags(flags)
        self.device = torch.device(device)
        self.r_up = math.sqrt(float(flags["mu"]))
        self.slope = float(str(flags["activation"]).replace("lrelu", ""))
        self.w, self.M = masks(int(flags["neigs"]), self.device)
        self.clip = float(flags.get("grad_clip", 0.0))
        self.momentum = float(flags["momentum"])
        self.lr = float(flags["base_lr"])
        self.total = (int(flags["num_epochs"]) * steps_per_epoch
                      if flags.get("use_lr_scheduler") else 0)

    def tower(self, params: dict, side: str, v: torch.Tensor) -> torch.Tensor:
        n = len([k for k in params if k.startswith(f"{side}.") and k.endswith(".w")])
        h = v
        for i in range(n):
            h = h @ params[f"{side}.layers.{i}.w"] + params[f"{side}.layers.{i}.b"]
            if i < n - 1:
                h = torch.where(h >= 0, h, self.slope * h)
        norms = torch.linalg.vector_norm(h, dim=1, keepdim=True)
        return torch.where(norms < self.r_up, h, self.r_up * h / torch.clamp(norms, min=1e-12))

    def loss_and_grads(self, params: dict, x: torch.Tensor, y: torch.Tensor):
        fx, gy = self.tower(params, "x", x), self.tower(params, "y", y)
        B = fx.shape[0]
        ones = torch.ones((B, 1), device=fx.device)
        f, g = torch.cat([ones, fx.detach()], 1), torch.cat([ones, gy.detach()], 1)
        lam_f, lam_g = f.T @ f / B, g.T @ g / B
        op_term = -2.0 * torch.mean(torch.sum(self.w * f * g, dim=1))
        metric_term = torch.sum(self.M * lam_f * lam_g)
        loss = op_term + metric_term
        self.loss_scale = float(op_term.abs() + metric_term.abs())
        grad_f = (2.0 / B) * f @ (self.M * lam_g) - (2.0 / B) * self.w * g
        grad_g = (2.0 / B) * g @ (self.M * lam_f) - (2.0 / B) * self.w * f
        names = list(params)
        grads = torch.autograd.grad((fx, gy), [params[k] for k in names],
                                    grad_outputs=(grad_f[:, 1:], grad_g[:, 1:]))
        return loss.detach(), dict(zip(names, grads))

    def learning_rate(self, t: int) -> float:
        if not self.total:
            return self.lr
        return self.lr * 0.5 * (1 + math.cos(math.pi * t / self.total))


def train_steps(flags: dict, steps_per_epoch: int, weights: dict, batches, device,
                fault: str = "") -> dict:
    """One step on each (x, y) of ``batches`` from ``weights``.

    Returns {"losses", "loss_scales" (|operator term| + |metric term| of
    each loss), "first_grads": {name: ‖clipped g‖ of step 1},
    "params": {name: after the last step}}.  ``fault`` plants one of the
    program's faults here, for their readings: "half_batch" (each step on
    the first half of its rows), "grad_leaf" (the first parameter's
    gradient times 1.5 where it is produced)."""
    prob = Problem(flags, steps_per_epoch, device)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in weights.items()}
    taken = 0
    losses, scales, first = [], [], None
    for x, y in batches:
        if fault == "half_batch":
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        loss, grads = prob.loss_and_grads(params, x, y)
        if fault == "grad_leaf":
            k = next(iter(grads))
            grads[k] = 1.5 * grads[k]
        with torch.no_grad():
            if prob.clip > 0:
                gnorm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads.values()]))
                scale = torch.clamp(prob.clip / (gnorm + 1e-6), max=1.0)
                grads = {k: g * scale for k, g in grads.items()}
            losses.append(float(loss))
            scales.append(prob.loss_scale)
            if first is None:
                first = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            if all(bool(torch.isfinite(g).all()) for g in grads.values()):
                lr = prob.learning_rate(taken)
                for k, g in grads.items():
                    mom[k] = g + prob.momentum * mom[k]
                    params[k].add_(-lr * mom[k])
                taken += 1
    return {"losses": losses, "loss_scales": scales, "first_grads": first,
            "params": {k: v.detach() for k, v in params.items()}}
