"""The kernel-operator EVD path: ``MatrixOperator``, ``KernelOperator`` and
every method's ``loss_and_grad_kernel`` against the JAX package, and the
driver on a fixed-landmark kernel operator (tests/test_training.py:130-168
in the port).

Same numpy inputs and, through ``convert.params_from_jax``, the same
weights in both packages; an RBF kernel exp(-‖a - b‖²) on 2D standard
normal samples.  The JAX tests' tolerances: rtol 1e-5 on losses and
states, rtol 1e-4 / atol 1e-6 of the largest entry on gradients.  SpIN and
SpINx whiten by a Cholesky factor with a 1e-3 jitter, which amplifies
float32 rounding, so they run model and state in float64 in both
packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neuralsvd_tpu.methods.nestedlora import NestedLoRA as JaxNestedLoRA
from neuralsvd_tpu.methods.neuralef import NeuralEigenfunctions as JaxNEF
from neuralsvd_tpu.methods.spin import SpIN as JaxSpIN
from neuralsvd_tpu.methods.spinx import SpINx as JaxSpINx
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.operators.base import KernelOperator as JaxKernelOperator
from neuralsvd_tpu.operators.base import MatrixOperator as JaxMatrixOperator
from neuralsvd_tpu_torch.convert import _named_leaves, method_state_from_jax, params_from_jax
from neuralsvd_tpu_torch.data.samplers import get_sampler, make_val_grid
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.neuralef import NeuralEigenfunctions
from neuralsvd_tpu_torch.methods.spin import SpIN
from neuralsvd_tpu_torch.methods.spinx import SpINx
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.base import KernelOperator, MatrixOperator
from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.training.optimizers import build_optimizer
from neuralsvd_tpu_torch.training.train_operator import train_operator

L, B = 4, 64
# per-mode 16-16 softplus towers on the raw 2D input
TOWERS = dict(ndim=2, neigs=L, mlp_hidden_dims=[16, 16], nonlinearity="softplus",
              parallel=True, use_fourier_feature=False, apply_boundary=False)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
DECAY = 0.3  # SpIN's and SpINx's EMA, far from 0 so the state matters
# method -> (JAX class, port class, port options, float64)
METHODS = {
    "nestedlora": (JaxNestedLoRA, NestedLoRA, dict(use_pallas=False), False),
    "nestedlora-kernels": (JaxNestedLoRA, NestedLoRA, dict(use_pallas=True), False),
    "neuralef": (JaxNEF, NeuralEigenfunctions, {}, False),
    "spin": (JaxSpIN, SpIN, dict(decay=DECAY), True),
    "spinx": (JaxSpINx, SpINx, dict(decay=DECAY), True),
}


def jax_rbf(a, b):
    return jnp.exp(-jnp.sum((a[:, None] - b[None]) ** 2, -1))


def rbf(a, b):
    return torch.exp(-torch.sum((a[:, None] - b[None]) ** 2, -1))


def _x(n=B, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2))


def _close(got, want, rtol, what, atol=0.0):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-300), err_msg=what)


def _carried(seed=0, float64=False):
    jinit, japply = jax_make_wavefunctions(**TOWERS)
    params = jinit(jax.random.key(seed))
    model = make_wavefunctions(**TOWERS, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    if float64:
        model.double()
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return params, japply, model


def test_matrix_and_kernel_operators_match_jax():
    """Tf and fs of both operators equal JAX's; with_graph=True the VJP of
    (Tf, fs) equals jax.vjp's (the kernel operator's landmarks values
    included); by default Tf carries no graph and fs does.  The fixed
    landmarks are kept on the device once."""
    params, japply, model = _carried(1)
    x = _x(seed=2).astype(np.float32)
    land = _x(32, seed=3).astype(np.float32)
    A = np.random.default_rng(4).normal(size=(B, B)).astype(np.float32)
    cots = np.random.default_rng(5).normal(size=(2, B, L)).astype(np.float32)
    for jop, op in ((JaxMatrixOperator(A), MatrixOperator(A)),
                    (JaxKernelOperator(jax_rbf, jnp.asarray(land)), KernelOperator(rbf, land))):
        (jT, jf), vjp = jax.vjp(lambda p: jop(lambda xx: japply(p, xx), jnp.asarray(x)), params)
        jg = {k: np.asarray(v) for k, v in _named_leaves(vjp((jnp.asarray(cots[0]),
                                                             jnp.asarray(cots[1])))[0])}
        Tf, fs = op(model, torch.as_tensor(x), with_graph=True)
        _close(Tf, jT, LOSS_RTOL, "Tf", 1e-6)
        _close(fs, jf, LOSS_RTOL, "fs", 1e-6)
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad([Tf, fs], list(model.parameters()),
                                    [torch.as_tensor(c) for c in cots])
        for k, g in zip(names, grads):
            _close(g, jg[k], GRAD_RTOL, k, GRAD_ATOL)
        Tf0, fs0 = op(model, torch.as_tensor(x))
        assert not Tf0.requires_grad and fs0.requires_grad
        assert torch.equal(Tf0, Tf.detach())
    held = op.landmarks.like(torch.as_tensor(x))
    assert held is op.landmarks.like(torch.as_tensor(x))  # made once a device


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("name", sorted(METHODS))
def test_kernel_path_matches_jax(name, split):
    """loss_and_grad_kernel of each method, with and without split_batch,
    on the landmarks the batch gives (x itself; split: x2 for x1 and, for
    NeuralEF, x1 for x2): the loss, every gradient and the new state
    against JAX's; NestedLoRA's kernel packaging (use_pallas=True, its
    wrappers' plain versions on the CPU) too, launching nothing here."""
    jcls, tcls, opts, float64 = METHODS[name]
    params, japply, model = _carried(6, float64)
    jopts = {k: v for k, v in opts.items() if k != "use_pallas"}
    jm, tm = jcls(japply, L, **jopts), tcls(model, L, **opts)
    x = _x(seed=7)
    tparams = dict(model.named_parameters())
    with jax.enable_x64(float64):
        jp = jax.tree.map(jnp.asarray, params)
        jstate = jm.init_state(jp)
        jl, jg, jaux, jnew = jm.loss_and_grad_kernel(
            jp, jstate, jnp.asarray(x, jp["base"]["ws"][0].dtype),
            lambda lm: JaxKernelOperator(jax_rbf, lm), split_batch=split)
        jg = {k: np.asarray(v) for k, v in _named_leaves(jg)}
        jnew = jax.tree.map(np.asarray, jnew)
        jf = np.asarray(jaux["f"])
    state = tm.init_state(tparams)  # in the parameters' dtype
    cuda_gram.reset_launch_counts()
    loss, grads, aux, new = tm.loss_and_grad_kernel(
        tparams, state, torch.as_tensor(x, dtype=next(model.parameters()).dtype),
        lambda lm: KernelOperator(rbf, lm), split_batch=split)
    assert not any(cuda_gram.launch_counts().values())
    _close(loss, jl, LOSS_RTOL, "loss")
    _close(aux["f"], jf, LOSS_RTOL, "f", 1e-6)
    assert set(grads) == set(jg)
    for k, w in jg.items():
        _close(grads[k], w, GRAD_RTOL, f"grad {k}", GRAD_ATOL)
    want = method_state_from_jax(jnew, per_mode=getattr(tm, "per_mode", ()),
                                 dtype=torch.float64)
    assert set(new) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):  # SpIN's j_avg, compact on the towers
            for n, j in w.items():
                _close(new[k][n], j.numpy(), LOSS_RTOL, f"{k}[{n}]", GRAD_ATOL)
        elif w.dtype == torch.bool:
            assert torch.equal(new[k], w), k
        else:
            _close(new[k], w.numpy(), LOSS_RTOL, k, GRAD_ATOL)


def test_split_batch_sends_halves_to_the_evd_kernels():
    """With split_batch, the EVD packaging sees fs = f1 (B/2 rows) against
    Kf1, and the halves (f1, f2): its loss equals the plain EVD loss on the
    same split (so its K2 takes as many rows as f1)."""
    _, _, model = _carried(8)
    x = torch.as_tensor(_x(seed=9), dtype=torch.float32)
    params = dict(model.named_parameters())
    op = lambda lm: KernelOperator(rbf, lm)  # noqa: E731
    out = [NestedLoRA(model, L, use_pallas=flag).loss_and_grad_kernel(
        params, {}, x, op, split_batch=True) for flag in (True, False)]
    (lk, gk, ak, _), (lp, gp, ap, _) = out
    assert ak["f"].shape == (B // 2, L) and ak["Tf"].shape == (B // 2, L)
    _close(lk, lp.item(), LOSS_RTOL, "loss")
    for k, g in gp.items():
        _close(gk[k], g.numpy(), GRAD_RTOL, k, GRAD_ATOL)


class Linear(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.W = nn.Parameter(torch.as_tensor(w))

    def forward(self, x):
        return x @ self.W


@pytest.mark.parametrize("monitor", [True, False], ids=["monitor", "blocks"])
def test_train_operator_end_to_end_kernel(monitor):
    """The driver on a fixed RBF kernel operator (64 landmarks), a linear
    model, sequential NestedLoRA, RMSprop: 300 steps with evals at 150 and
    300 (eager steps with the monitor, blocks of 50 without): finite
    losses, no blow-up, positive Rayleigh quotients (the kernel is PSD)."""
    D, Lk = 2, 3
    rng = np.random.default_rng(0)
    landmarks = rng.normal(size=(64, D)).astype(np.float32)
    operator = KernelOperator(rbf, landmarks)
    model = Linear(0.3 * rng.normal(size=(D, Lk)).astype(np.float32))
    method = NestedLoRA(model, neigs=Lk, sequential=True)
    sample, _ = get_sampler("gaussian", 64, 1, D, 1.0, device="cpu")
    optimizer = build_optimizer("rmsprop", 1e-2)
    _, val_batches, _ = make_val_grid(D, 1.0, 0.25, 32)
    losses = []

    class Writer:
        def writerow(self, r):
            losses.append(r["train_loss"])

    ts, all_eigvals, _ = train_operator(
        method, operator, sample, optimizer, model, num_iters=300,
        val_batches=val_batches, ema_decay=0.9, eval_freq=150, print_freq=50,
        log_writer=Writer(), monitor=monitor)
    assert len(all_eigvals) == 2 and all_eigvals[0].shape == (Lk,)
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] + 0.05
    assert np.all(all_eigvals[-1] > 0)
    assert int(ts.step) == 300
