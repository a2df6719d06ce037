"""SpIN (Spectral Inference Networks): the dual-channel masked gradient.

Port of ``neuralsvd_tpu/methods/spin.py``: ``spin_step`` (:32-39),
``spin_grad_matrices`` (:42-53) and ``SpIN`` (:56-179).  The gradient is
the sum of two channels:

- π: the VJP of (Tφ, φ) with the reference's deliberately swapped pair of
  cotangents (φ·gπ/B for Tφ, Tφ·gπ/B for φ; :99-105), so the operator is
  called with ``with_graph=True`` (finite differences or nested JVPs);
- σ: an EMA ``j_avg`` of the Jacobian j[m, l] = 2/B Σ_b φ[b,m] ∂φ[b,l]/∂θ
  (:107-115), contracted with gσ (:118-119).

``j_avg`` is stored per parameter in one of two layouts of the same
numbers.  JAX's dense (L, L, *shape), filled by L² reverse passes, for a
parameter shared by the modes (the shared trunk).  For a parameter whose
slot l feeds output l only (the model's ``per_mode_parameters()``: the
ParallelMLP stacks and the exponential mask's scales) every block with
l ≠ slot is exactly zero, so the port keeps the diagonal blocks, (L,
*shape) with entry [m, s] = dense[m, s, s], and fills them with L reverse
passes: pass m sends 2/B φ[:, m] into every output column.  At the
hydrogen.sh width (L 36, 10.67M parameters) that is 1.54 GB where the
dense form needs 55.3 GB.

The state (``sigma_avg``, ``chol``, ``j_avg``) is updated in place, also
on a step the driver then skips, as JAX keeps it, and returned as the same
tensors: a captured step writes it on every replay without a copy.  The
Cholesky factor is NaN where its matrix is not positive definite, as
``jnp.linalg.cholesky`` returns, without a host read.  The kernel-operator
path (``loss_and_grad_kernel``, :126-171) is the operator path with the
batch as its own landmarks; split, σ comes from [φ1; φ2] while π and the
Jacobian come from the first half (x2 its landmarks), JAX's ``jacrev`` of
2/B φ1_sgᵀ φ1(θ) being the compact ``_jacobian`` on x1 with φ1 detached.

``axis_name`` (a data-parallel process group, parallel/collectives.py, or
None): σ and π are averaged over the group's ranks, and the π channel's
cotangents divide by the global batch (B·n).  The Jacobian stays the local
rows' one: JAX's ``jacrev`` of ``pmean(g)`` under ``shard_map(check_vma=
False)`` sends each basis cotangent through psum(ct)/n, which gives it back
unchanged.  So each rank's ``j_avg`` and σ-channel gradient are its own
until the dp train step averages the state and sums the gradients over the
ranks (parallel/sharding.py).

``mode_axis`` (the tensor-parallel group, or None): the model is a rank's
share (``parallel.sharding.shard_module``), whose outputs are the modes
``[lo, hi)`` of ``parallel.mesh.mode_range``.  φ and Tφ (and, split, σ's
rows [φ1; φ2]) are gathered along the modes before σ and π, so σ, π, gσ,
gπ, ``sigma_avg`` and ``chol`` are whole and equal on every rank, and the
π channel's VJP goes through the gather's backward, which hands each rank
its modes' slice.  The σ channel differentiates the rank's own outputs
with the gathered φ in the cotangent: a per-mode leaf's compact ``j_avg``
is then (L, hi-lo, ...), entry [m, s] for the rank's slot s (L passes over
a network of the rank's modes), and a replicated leaf upstream of the
gather holds the rank's columns j[:, lo:hi] of its dense layout, whose
contraction with gσ[:, lo:hi] is partial: the mesh step sums such a
leaf's gradient over tp (``ModeShards.pre_gather``), π channel and σ
channel at once.  So every leaf of ``j_avg`` has its modes on axis 1
(``state_mode_axes``), where the name-matched ``ModeShards.narrow_tree``
would take axis 0.  Under dp x tp the batch is one global batch split over
the dp ranks (the JAX GSPMD path's semantics): the σ channel's contraction
divides by the dp size, each rank's share of the mean Jacobian's, and the
train step's dp mean of the state and sum of the gradients complete it;
the dp ranks at one tp index hold the same slots, so that mean is right.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from neuralsvd_tpu_torch.ops.gram import global_batch_size
from neuralsvd_tpu_torch.parallel.collectives import axis_size, gather_modes, pmean
from neuralsvd_tpu_torch.parallel.mesh import mode_range
from neuralsvd_tpu_torch.utils.tracing import span

JITTER = 1e-3
# the profiler ranges of a step: the π channel (operator and its VJP), the
# σ channel's Jacobian refill, and the j_avg EMA and contraction
PROFILE_RANGES = ("spin.pi_channel", "spin.sigma_channel", "spin.j_avg")


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of ``a``; where ``a`` is not positive
    definite, NaN on and below the diagonal and zero above, as
    ``jnp.linalg.cholesky`` returns (no error check, so no host read)."""
    chol, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")).tril())


def spin_step(sigma, pi, jitter: float = JITTER):
    """(chol, chol⁻¹, Λ = chol⁻¹ π chol⁻ᵀ, diag Λ) of the whitening step."""
    L = sigma.shape[0]
    eye = torch.eye(L, dtype=sigma.dtype, device=sigma.device)
    chol = cholesky_or_nan(sigma + jitter * eye)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    Lambda = chol_inv @ pi @ chol_inv.T
    return chol, chol_inv, Lambda, torch.diagonal(Lambda)


def spin_grad_matrices(sigma_avg, pi):
    """(loss, eigvals, chol, gσ, gπ): the trace loss and the two masked
    gradient matrices."""
    chol, chol_inv, Lambda, eigvals = spin_step(sigma_avg, pi)
    loss = torch.trace(Lambda)
    diag_chol_inv = torch.diag(torch.diagonal(chol_inv))
    gsigma = chol_inv.T @ torch.triu(Lambda @ diag_chol_inv)
    gpi = -chol_inv.T @ diag_chol_inv
    return loss, eigvals, chol, gsigma, gpi


def require_device_bytes(nbytes: int, device, free: Optional[int] = None) -> None:
    """Raise MemoryError, naming the bytes, when ``nbytes`` exceed the free
    memory of a CUDA ``device`` (``free`` defaults to what the device
    reports; other devices are not checked)."""
    device = torch.device(device)
    if free is None:
        if device.type != "cuda":
            return
        free = torch.cuda.mem_get_info(device)[0]
    if nbytes > free:
        raise MemoryError(
            f"SpIN's Jacobian average and its refill need {nbytes} bytes; "
            f"{free} are free on {device}")


def _batched_grad(out, leaves, cotangents, retain_graph):
    """The VJPs of ``out`` for a stack of cotangents: each leaf's (n,
    *shape), zeros for a leaf ``out`` does not reach."""
    grads = torch.autograd.grad(out, leaves, cotangents, is_grads_batched=True,
                                retain_graph=retain_graph, allow_unused=True)
    n = cotangents.shape[0]
    return [g if g is not None else p.new_zeros((n,) + p.shape)
            for g, p in zip(grads, leaves)]


class SpIN:
    name = "spin"

    def __init__(self, model: nn.Module, neigs: int, decay: float = 0.01,
                 axis_name=None, mode_axis=None):
        """decay: 0 = frozen moving average, 1 = no memory."""
        self.model = model
        self.neigs = neigs
        self.decay = decay
        self.axis_name = axis_name
        self.mode_axis = mode_axis
        declared = getattr(model, "per_mode_parameters", None)
        self.per_mode = frozenset(declared() if declared is not None else ())
        self.lo, self.hi = mode_range(neigs, mode_axis)
        if mode_axis is not None:
            axes = dict(getattr(model, "mode_axes", dict)())
            if any(k not in self.per_mode or a != 0 for k, a in axes.items()):
                raise ValueError(f"SpIN on a tp group needs every mode-sharded parameter "
                                 f"per-mode on its leading axis: {axes}")

    def _apply(self, params, x):
        return functional_call(self.model, params, (x,))

    def _modes(self, t):
        """All L modes of a rank's outputs ``t`` under ``mode_axis``."""
        return gather_modes(t, self.mode_axis, self.neigs)

    def _j_shape(self, name, p) -> tuple:
        L = self.neigs
        return ((L,) if name in self.per_mode else (L, self.hi - self.lo)) + tuple(p.shape)

    def state_bytes(self, params) -> int:
        """The bytes of ``j_avg`` for ``params`` (a rank's share under
        ``mode_axis``)."""
        return sum(torch.Size(self._j_shape(k, p)).numel() * p.element_size()
                   for k, p in params.items())

    def state_mode_axes(self):
        """The mode axis of each sharded leaf of the state: axis 1 of every
        ``j_avg`` leaf (a per-mode leaf's slot, a dense leaf's column);
        ``sigma_avg`` and ``chol`` are whole on every rank."""
        return {"j_avg": {k: 1 for k, _ in self.model.named_parameters()}}

    def init_state(self, params):
        """Zero ``sigma_avg`` and ``j_avg``, identity ``chol``, in the
        parameters' dtype; raises MemoryError where ``j_avg`` and one
        refill would not fit the device."""
        p0 = next(iter(params.values()))
        require_device_bytes(2 * self.state_bytes(params), p0.device)
        L = self.neigs
        return {
            "sigma_avg": p0.new_zeros((L, L)),
            "chol": torch.eye(L, dtype=p0.dtype, device=p0.device),
            "j_avg": {k: p.new_zeros(self._j_shape(k, p)) for k, p in params.items()},
        }

    def eval_apply(self, params, state, x):
        """The outputs whitened by the stored Cholesky factor."""
        out = self._apply(params, x)
        return torch.linalg.solve_triangular(state["chol"], out.T, upper=False).T

    def _jacobian(self, params, x, phi) -> Dict[str, torch.Tensor]:
        """j_new[m, l] = 2/B Σ_b φ[b,m] ∂φ[b,l]/∂θ in each leaf's layout,
        for the model's own output columns l (the rank's modes under
        ``mode_axis``; ``phi`` has all L), from a B-row model call: L
        passes (one batched call) when every leaf is per-mode, else one
        batched call of L one-hot cotangents per output column."""
        names = list(params)
        leaves = [params[k] for k in names]
        out = self._apply(params, x)
        B, n = out.shape
        L = phi.shape[1]
        c = (2.0 / B) * phi.T  # (m, b)
        if all(k in self.per_mode for k in names):
            cot = c[:, :, None].expand(L, B, n)
            return dict(zip(names, _batched_grad(out, leaves, cot, False)))
        j_new = {k: p.new_empty(self._j_shape(k, p)) for k, p in params.items()}
        for col in range(n):
            cot = out.new_zeros((L, B, n))
            cot[:, :, col] = c
            grads = _batched_grad(out, leaves, cot, col < n - 1)
            for k, g in zip(names, grads):
                j_new[k][:, col] = g[:, col] if k in self.per_mode else g
        return j_new

    def _contract(self, name, gsigma, j):
        """Σ_{m,l} gσ[m, l] j[m, l] in the leaf's layout, over the rank's
        columns l under ``mode_axis``."""
        gsigma = gsigma[:, self.lo:self.hi]
        if name in self.per_mode:
            return torch.einsum("ms,ms...->s...", gsigma, j)
        return torch.tensordot(gsigma, j, dims=2)

    def loss_and_grad(self, params, state, x, operator, importance=None):
        """(loss, grads {name: tensor}, aux {f, Tf, eigvals}, state); the
        state's tensors are updated in place and returned.  Its three parts
        run in the profiler ranges ``PROFILE_RANGES``."""
        def pi_inputs():
            Tphi, phi = operator(lambda xx: self._apply(params, xx), x, importance,
                                 with_graph=True)
            phi = self._modes(phi)
            return self._modes(Tphi), phi, phi.detach(), x

        return self._step(params, state, pi_inputs)

    def loss_and_grad_kernel(self, params, state, x, get_approx_kernel_op,
                             importance=None, split_batch: bool = False):
        """The kernel-operator path: ``get_approx_kernel_op(landmarks)`` is
        an operator (``operators.base.KernelOperator``).  Without
        ``split_batch`` it is ``loss_and_grad`` with the batch as its own
        landmarks; with it σ comes from [φ1; φ2] and π, the π channel's VJP
        and the Jacobian from x1 (landmarks x2).  Returns as
        ``loss_and_grad``, aux {f: φ1, Tf: Kφ1} when split."""
        if not split_batch:
            def op(model, xx, imp=None, **kw):
                return get_approx_kernel_op(xx)(model, xx, imp, **kw)

            return self.loss_and_grad(params, state, x, op, importance)
        if x.shape[0] % 2:
            raise ValueError("the batch must split into two equal halves")
        x1, x2 = torch.chunk(x, 2)

        def pi_inputs():
            model = lambda xx: self._apply(params, xx)  # noqa: E731
            Kphi1, phi1 = get_approx_kernel_op(x2)(model, x1, importance, with_graph=True)
            phi1 = self._modes(phi1)
            with torch.no_grad():  # φ2 enters σ only, which takes no gradient
                phi2 = self._modes(model(x2))
            return self._modes(Kphi1), phi1, torch.cat([phi1.detach(), phi2]), x1

        return self._step(params, state, pi_inputs)

    def _step(self, params, state, pi_inputs):
        """The step of ``loss_and_grad`` on ``pi_inputs() -> (Tφ, φ with
        their graphs, the rows of σ's batch, the input of φ's rows)``."""
        names = list(params)
        pi_range, sigma_range, j_range = PROFILE_RANGES
        with span(pi_range):
            Tphi, phi, phi_sigma, x = pi_inputs()
            B = phi.shape[0]
            phi_d, Tphi_d = phi.detach(), Tphi.detach()
            group = self.axis_name
            with torch.no_grad():
                sigma = pmean(phi_sigma.T @ phi_sigma / phi_sigma.shape[0], group)
                sigma_avg = state["sigma_avg"].lerp_(sigma, self.decay)
                pi = pmean(phi_d.T @ Tphi_d / B, group)
                loss, eigvals, chol, gsigma, gpi = spin_grad_matrices(sigma_avg, pi)
                state["chol"].copy_(chol)
            # Tφ takes φ·gπ/B and φ takes Tφ·gπ/B (B global): the
            # reference's swapped pair ("crucial for the correct behavior")
            Bn = global_batch_size(B, group)
            grads_pi = torch.autograd.grad(
                [Tphi, phi], [params[k] for k in names],
                [phi_d @ gpi / Bn, Tphi_d @ gpi / Bn],
                allow_unused=True, materialize_grads=True)
        with span(sigma_range):
            j_new = self._jacobian(params, x, phi_d)
        if self.mode_axis is not None and group is not None:
            gsigma = gsigma / axis_size(group)  # a dp rank's share (module docstring)
        grads = {}
        with span(j_range), torch.no_grad():
            for k, g_pi in zip(names, grads_pi):
                j = state["j_avg"][k].lerp_(j_new.pop(k), self.decay)
                grads[k] = g_pi + self._contract(k, gsigma, j)
        return loss, grads, dict(f=phi_d, Tf=Tphi_d, eigvals=eigvals), state
