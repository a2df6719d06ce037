"""Plain PyTorch reference of the E4 hydrogen training step.

What one step computes, from the recipe's published description (the
NeuralSVD paper's operator-EVD loss with sequential nesting, BASELINE.md run
E4) and written here without any code of the port:

1. The batch: B points of a mixture of K centred Gaussians with standard
   deviations ``sampling_scales`` and equal weights, drawn as one uniform a
   row (the component by inverse CDF) and one standard normal pair a row,
   from a ``torch.Generator`` on the device seeded from (seed, block start,
   stream 0) by ``block_seed``.  ``w(x)``, the mixture density, is the
   importance weight.
2. The features of x (B, 2): ``[sin(xF), cos(xF), r, exp(-κ_k r)]`` with
   ``F = 2π·fourier_scale·N(0, 1)`` of shape (2, m) drawn from
   ``numpy.random.default_rng(seed)``, ``r = sqrt(|x|² + 1e-12)``.
3. L towers, each ``features -> 128 -> 128 -> 128 -> 1`` with softplus
   between layers; layer i of tower l is ``W_i[l] h + b_i[l]``.
4. The operator: with g = √w·f, ``lap = ∇²g / max(√w, 1e-5)`` and
   ``fs = g / max(√w, 1e-5)``; ``Tf = s·(lap - V·fs)`` with
   ``V = -1/|x|`` and s the operator scale.  The Laplacian is taken by
   reverse-mode autograd twice (the port takes it forward, in one pass).
   Tf carries no gradient.
5. The loss with fs split into halves f1, f2 (rows [0, B/2) and [B/2, B)):
   ``-2·mean_b Σ_l fs_bl Tf_bl + Σ_lm M_lm Λ1_lm Λ2_lm``, Λi = fiᵀfi/(B/2),
   M upper triangular (mode m sees modes l <= m).  Its gradient is the
   estimator, not the derivative of that scalar: fs gets -4/B·Tf, and the
   rows of f1 get (2/(B/2))·f1 (M⊙Λ2), those of f2 (2/(B/2))·f2 (M⊙Λ1).
6. A non-finite loss or gradient norm skips the update (parameters and
   optimizer state kept; the EMA and the step count still move).
7. RMSprop in torch's order, ``ν <- αν + (1-α)g²``, update
   ``-lr(t)·g/(√ν + 1e-10)``, lr(t) the cosine ``lr/2·(1 + cos(πt/T))``
   over the recipe's T steps, t the number of updates taken.
8. The EMA of the parameters with torch_ema's ramp,
   ``d = min(decay, (1+t)/(10+t))``, t the step index.

Everything runs in float32 with TF32 off.  The harness hands this module
the initial weights it made (``make_weights``) and the seed; nothing of
the program's state is read.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the flags this reference implements, with the value each must have
ASSUMED = {"potential_type": "hydrogen", "ndim": 2, "parallel": True,
           "apply_boundary": False, "laplacian_eps": -1.0, "charge": 1.0,
           "use_fourier_feature": True, "fourier_append_radial": True,
           "fourier_deterministic": False, "fourier_append_raw": False,
           "sampling_mode": "gaussian_mixture", "optimizer": "rmsprop",
           "momentum": 0.0, "grad_clip": 0.0, "spike_reject_factor": 0.0,
           "nonlinearity": "softplus", "neuralsvd.sequential": True}


def check_flags(flags: dict) -> None:
    """Raise where the configuration asks for something this reference
    does not compute."""
    for key, want in ASSUMED.items():
        got = flags.get(key, want)
        if got != want:
            raise ValueError(f"the E4 reference computes {key}={want!r}, not {got!r}")


def _floats(text) -> list:
    return [float(v) for v in str(text).split(",") if v]


def param_shapes(flags: dict) -> dict:
    """{name: shape} of the towers' parameters, named as the program
    names them (``base.ws.<i>`` (L, out, in), ``base.bs.<i>`` (L, out, 1))."""
    L = int(flags["neigs"])
    m = int(flags["fourier_mapping_size"])
    n_env = len(_floats(flags.get("fourier_append_envelopes", "")))
    dims = [2 * m + 1 + n_env] + [int(h) for h in str(flags["mlp_hidden_dims"]).split(",")] + [1]
    shapes = {}
    for i in range(len(dims) - 1):
        shapes[f"base.ws.{i}"] = (L, dims[i + 1], dims[i])
        shapes[f"base.bs.{i}"] = (L, dims[i + 1], 1)
    return shapes


def make_weights(flags: dict, seed: int, device) -> dict:
    """The initial weights from ``seed``, on ``device``, one draw a
    tensor from one generator: N(0, 2/fan_in) weights, N(0, 0.01²) biases."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in param_shapes(flags).items():
        std = math.sqrt(2.0 / shape[2]) if ".ws." in name else 0.01
        out[name] = std * torch.randn(shape, generator=gen, device=device)
    return out


def block_seed(seed: int, start: int, stream: int = 0) -> int:
    """The seed of the sample generator for the block at ``start``."""
    hi, lo = np.random.SeedSequence([seed, start, stream]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


class Problem:
    """The fixed parts of one configuration and seed on one device."""

    def __init__(self, flags: dict, seed: int, device):
        check_flags(flags)
        self.device = torch.device(device)
        self.B = int(flags["batch_size"])
        self.L = int(flags["neigs"])
        rng = np.random.default_rng(seed)
        proj = 2 * np.pi * float(flags["fourier_scale"]) * rng.standard_normal(
            (2, int(flags["fourier_mapping_size"])))
        self.proj = torch.as_tensor(proj, dtype=torch.float32, device=self.device)
        self.kappas = torch.tensor(_floats(flags.get("fourier_append_envelopes", "")),
                                   dtype=torch.float32, device=self.device)
        scales = np.asarray(_floats(flags["sampling_scales"]), dtype=np.float64)
        self.scales = torch.tensor(scales, dtype=torch.float32, device=self.device)
        weights = np.full(len(scales), 1.0 / len(scales))
        self.cdf = torch.tensor(np.cumsum(weights)[:-1], dtype=torch.float32,
                                device=self.device)
        self.log_w = torch.tensor(np.log(weights), dtype=torch.float32, device=self.device)
        self.log_norm = torch.tensor(-np.log(2 * np.pi * scales ** 2),
                                     dtype=torch.float32, device=self.device)
        self.op_scale = float(flags["operator_scale"])
        self.lr = float(flags["lr"])
        self.alpha = float(flags["rmsprop_decay"])
        self.schedule_steps = int(flags["num_iters"]) if flags.get("use_lr_scheduler") else 0
        self.ema_decay = float(flags["ema_decay"])

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        u = torch.rand((self.B, 1), generator=gen, device=self.device)
        comp = torch.sum(u >= self.cdf, dim=1)
        return self.scales[comp][:, None] * torch.randn((self.B, 2), generator=gen,
                                                          device=self.device)

    def density(self, x: torch.Tensor) -> torch.Tensor:
        r2 = torch.sum(x * x, dim=1, keepdim=True)
        return torch.exp(torch.logsumexp(self.log_w + self.log_norm - 0.5 * r2 / self.scales ** 2,
                                         dim=1, keepdim=True))

    def model(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(B, 2) -> (B, L)."""
        p = x @ self.proj
        r = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-12)
        h = torch.cat([torch.sin(p), torch.cos(p), r, torch.exp(-r * self.kappas)], dim=1)
        n = len([k for k in params if k.startswith("base.ws.")])
        h = torch.einsum("lod,bd->lob", params["base.ws.0"], h) + params["base.bs.0"]
        for i in range(1, n):
            h = torch.einsum("lop,lpb->lob", params[f"base.ws.{i}"], F.softplus(h))
            h = h + params[f"base.bs.{i}"]
        return h[:, 0, :].T

    def operator(self, params: dict, x: torch.Tensor):
        """(Tf without a graph, fs with one) at x."""
        x = x.detach().requires_grad_(True)
        g = torch.sqrt(self.density(x)) * self.model(params, x)
        lap = torch.zeros_like(g)
        for l in range(g.shape[1]):
            (dg,) = torch.autograd.grad(g[:, l].sum(), x, create_graph=True)
            for d in range(x.shape[1]):
                (d2,) = torch.autograd.grad(dg[:, d].sum(), x, retain_graph=True)
                lap[:, l] += d2[:, d].detach()
        root = torch.clamp(torch.sqrt(self.density(x.detach())), min=1e-5)
        fs = g / root
        V = -1.0 / torch.linalg.vector_norm(x.detach(), dim=1, keepdim=True)
        Tf = self.op_scale * (lap / root - V * fs.detach())
        return Tf, fs

    def loss_and_grads(self, params: dict, x: torch.Tensor):
        """(loss, {name: gradient}) of the NestedLoRA estimator at x."""
        Tf, fs = self.operator(params, x)
        B = fs.shape[0]
        h = B // 2
        f = fs.detach()
        f1, f2 = f[:h], f[h:]
        M = torch.triu(torch.ones(self.L, self.L, device=f.device))
        lam1, lam2 = f1.T @ f1 / h, f2.T @ f2 / h
        op_term = -2.0 * torch.mean(torch.sum(f * Tf, dim=1))
        metric_term = torch.sum(M * lam1 * lam2)
        loss = op_term + metric_term
        self.loss_scale = float(op_term.abs() + metric_term.abs())
        grad_f = (-4.0 / B) * Tf
        grad_f = grad_f + torch.cat([(2.0 / h) * f1 @ (M * lam2),
                                     (2.0 / h) * f2 @ (M * lam1)])
        names = list(params)
        grads = torch.autograd.grad(fs, [params[k] for k in names], grad_outputs=grad_f)
        return loss.detach(), dict(zip(names, grads))

    def learning_rate(self, t: int) -> float:
        if not self.schedule_steps:
            return self.lr
        t = min(t, self.schedule_steps)
        return self.lr * 0.5 * (1 + math.cos(math.pi * t / self.schedule_steps))


def train_steps(flags: dict, seed: int, weights: dict, n_steps: int, device,
                fault: str = "") -> dict:
    """``n_steps`` steps from ``weights`` on the batches of the block at 0.

    Returns {"losses": [n], "loss_scales": [n] (|operator term| + |metric
    term| of each loss), "first_grads": {name: ‖g‖ of step 1},
    "params": {name: after n}, "ema": {name: after n}}.  ``fault`` plants
    one of the program's faults here, for their readings: "half_batch"
    (every step on the first half of its batch), "grad_leaf" (the first
    parameter's gradient times 1.5 where it is produced)."""
    prob = Problem(flags, seed, device)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    ema = {k: v.detach().clone() for k, v in weights.items()}
    nu = {k: torch.zeros_like(v) for k, v in weights.items()}
    updates_taken = 0
    gen = torch.Generator(device=prob.device).manual_seed(block_seed(seed, 0))
    losses, scales, first = [], [], None
    for t in range(n_steps):
        x = prob.sample(gen)
        if fault == "half_batch":
            x = x[:prob.B // 2]
        loss, grads = prob.loss_and_grads(params, x)
        if fault == "grad_leaf":
            k = next(iter(grads))
            grads[k] = 1.5 * grads[k]
        gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                      for g in grads.values()]))
        losses.append(float(loss))
        scales.append(prob.loss_scale)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        with torch.no_grad():
            if bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm)):
                lr = prob.learning_rate(updates_taken)
                for k, g in grads.items():
                    nu[k] = prob.alpha * nu[k] + (1 - prob.alpha) * g * g
                    params[k].add_(-lr * g / (torch.sqrt(nu[k]) + 1e-10))
                updates_taken += 1
            d = min(prob.ema_decay, (1 + t) / (10 + t))
            for k in ema:
                ema[k] = d * ema[k] + (1 - d) * params[k]
    return {"losses": losses, "loss_scales": scales, "first_grads": first,
            "params": {k: v.detach() for k, v in params.items()}, "ema": ema}
