"""Data parallelism: the port's ``parallel/`` and every loss's and method's
``axis_name`` on 2-rank gloo groups, against JAX's ``shard_map`` over 2 of
the 8 virtual CPU devices (tests/conftest.py) on the same per-rank inputs
(the methods: JAX's ``vmap`` with the same named axis, which gives
shard_map's values at a fraction of its compile time), and the dp train
steps against the port's single-process steps.

The ranks run in spawned processes (tests/torch_dp_workers.py, each spawn
bounded by its own timeout); the JAX references are made here.  The
tolerances are the JAX tests' (tests/test_parallel.py,
tests/test_nestedlora_ops.py): losses rtol 1e-5, gradients rtol 1e-4, atol
1e-6; the methods run in float64 in both packages (finite differences and
the forward engine carry the model's rounding into Tφ), at the SpIN tests'
rtol 1e-6, atol 1e-9 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dp_workers as workers
from neuralsvd_tpu.methods.factories import get_evd_method as jax_get_evd_method
from neuralsvd_tpu.models.wavefunctions import make_wavefunctions as jax_make_wavefunctions
from neuralsvd_tpu.ops.masks import joint_nesting_masks, step_weights
from neuralsvd_tpu.ops.nestedlora import (
    nestedlora_cdk_loss,
    nestedlora_evd_loss,
    nestedlora_svd_loss,
)
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.cli.sketchy import make_cdk_train_step
from neuralsvd_tpu_torch.convert import _named_leaves, method_state_from_jax, params_from_jax
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA, NestedLoRAForCDK
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.parallel import mesh as mesh_module
from neuralsvd_tpu_torch.parallel.mesh import given_sizes, mesh_sizes, parse_mesh_spec
from neuralsvd_tpu_torch.training.train_operator import block_seed, make_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state
from neuralsvd_tpu_torch.utils import config

L = workers.L
B = 32  # rows per rank


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


def _outs(d, world=2):
    return [dict(np.load(f"{d}/out.{r}.npz")) for r in range(world)]


def _rows(a, r):
    return workers._rows(np.asarray(a), r)


def test_parse_mesh_spec_grammar():
    """The grammar cases of tests/test_parallel.py::test_parse_mesh_spec_grammar."""
    assert parse_mesh_spec("dp", 8) == (("dp",), (8,))
    assert parse_mesh_spec("dp=4", 8) == (("dp",), (4,))
    assert parse_mesh_spec("dp=4,tp=2", 8) == (("dp", "tp"), (4, 2))
    assert parse_mesh_spec("dp,tp=2", 8) == (("dp", "tp"), (4, 2))
    assert parse_mesh_spec("tp=2", 8) == (("tp",), (2,))
    assert parse_mesh_spec("dp=4,tp=1", 8) == (("dp",), (4,))
    assert parse_mesh_spec("dp=1", 8) == (("dp",), (1,))
    for spec in ("dp=16", "dp,tp", "pp=2", "dp=3,tp"):
        with pytest.raises(ValueError):
            parse_mesh_spec(spec, 8)


def test_mesh_refusals_without_a_group(monkeypatch):
    """The refusals that remain before a group of several ranks runs: bad
    specs, a mesh wider than the ranks (one here; four through a stand-in
    rank count) and a batch that does not split into 2·dp halves; a tp axis
    parses and sizes, given or absorbed, for every loss, SpIN and SpINx
    included (the 4-rank spanning check:
    tests/test_torch_tp.py::test_tp_step_at_dp2_tp2_matches_jax_gspmd)."""
    for spec in ("pp=2", "dp,tp", "dp=2,dp=2", ""):
        with pytest.raises(ValueError):
            mesh_sizes(spec)
    for spec in ("tp=2", "dp=1,tp=2", "dp=4,tp=2"):
        with pytest.raises(ValueError, match="needs [0-9]+ devices, only 1"):
            mesh_sizes(spec)
    assert given_sizes("dp=4,tp=2") == {"dp": 4, "tp": 2} and given_sizes("dp,tp=2") == {"tp": 2}
    assert mesh_sizes("dp") == {"dp": 1} and mesh_sizes("dp=1,tp=1") == {"dp": 1}
    with pytest.raises(ValueError, match="2\\*dp=2"):
        pde.check_ported(config.PDEConfig(mesh="dp", batch_size=65))
    with pytest.raises(ValueError, match="needs 2 devices"):
        pde.check_ported(config.PDEConfig(mesh="dp=2"))
    monkeypatch.setattr(mesh_module, "_world_size", lambda: 4)
    assert mesh_sizes("dp=2,tp=2") == {"dp": 2, "tp": 2}
    assert mesh_sizes("tp") == {"tp": 4} and mesh_sizes("dp,tp=2") == {"dp": 2, "tp": 2}
    with pytest.raises(ValueError, match="needs 8 devices, only 4"):
        mesh_sizes("dp=4,tp=2")
    with pytest.raises(ValueError, match="2\\*dp=4"):
        pde.check_ported(config.PDEConfig(mesh="dp=2,tp=2", batch_size=66))
    pde.check_ported(config.PDEConfig(mesh="dp=2,tp=2", batch_size=64))
    for name in ("spin", "spinx"):
        for spec in ("tp=4", "dp=2,tp"):  # given, and absorbed from the 4 ranks
            pde.check_ported(config.PDEConfig(loss=config.LossConfig(name=name), mesh=spec))
        with pytest.raises(ValueError, match="needs 8 devices, only 4"):
            pde.check_ported(config.PDEConfig(loss=config.LossConfig(name=name),
                                              mesh="dp=2,tp=4"))


def test_block_seed_rank_zero_keeps_the_stream():
    """Rank 0 draws what a run without a mesh draws; other ranks differ."""
    assert block_seed(3, 100, 0, rank=0) == block_seed(3, 100, 0)
    assert len({block_seed(3, 100, 0, rank=r) for r in range(4)}) == 4


# -- the losses -------------------------------------------------------------------

def _loss_inputs(rng):
    n = 2 * B
    z = {k: rng.normal(size=(n, L)).astype(np.float32) for k in ("f", "Tf", "g", "Tg")}
    z["f1"], z["f2"] = (rng.normal(size=(n, L)).astype(np.float32) for _ in range(2))
    vm, mm = joint_nesting_masks(step_weights(L, 1))
    vm1, mm1 = joint_nesting_masks(step_weights(L, 1), True)
    z.update(vm=np.asarray(vm, np.float32), mm=np.asarray(mm, np.float32),
             vm1=np.asarray(vm1, np.float32), mm1=np.asarray(mm1, np.float32))
    return z


def _jax_losses(z):
    """Each device's loss and input gradients (its rows), taken inside
    shard_map as the dp step takes them (a cotangent of 1 on every
    device); the rows come back concatenated in device order."""
    j = {k: jnp.asarray(v) for k, v in z.items()}

    def evd(f, Tf, f1, f2):
        return nestedlora_evd_loss("dp", f, Tf, f1, f2, j["vm"], j["mm"])

    def svd(f, Tg, g, Tadjf):
        return nestedlora_svd_loss("dp", f, Tg, g, Tadjf, j["vm"], j["mm"])

    def cdk(f, g):
        loss, loss_op, loss_met, _, _ = nestedlora_cdk_loss("dp", True, f, g, j["vm1"],
                                                           j["mm1"], None)
        return loss, (loss_op, loss_met)

    def per_device(f, Tf, f1, f2, g, Tg):
        out = {}
        out["evd_loss"], grads = jax.value_and_grad(evd, argnums=(0, 2, 3))(f, Tf, f1, f2)
        out.update(zip(("evd_df", "evd_df1", "evd_df2"), grads))
        out["svd_loss"], grads = jax.value_and_grad(svd, argnums=(0, 2))(f, Tf, g, Tg)
        out.update(zip(("svd_df", "svd_dg"), grads))
        (out["cdk_loss"], (out["cdk_loss_operator"], out["cdk_loss_metric"])), grads = \
            jax.value_and_grad(cdk, argnums=(0, 1), has_aux=True)(f, g)
        out.update(zip(("cdk_df", "cdk_dg"), grads))
        return out

    specs = {k: P() if "loss" in k else P("dp") for k in (
        "evd_loss", "evd_df", "evd_df1", "evd_df2", "svd_loss", "svd_df", "svd_dg",
        "cdk_loss", "cdk_loss_operator", "cdk_loss_metric", "cdk_df", "cdk_dg")}
    fn = shard_map(per_device, mesh=_mesh(), in_specs=(P("dp"),) * 6, out_specs=specs,
                   check_vma=False)
    out = fn(j["f"], j["Tf"], j["f1"], j["f2"], j["g"], j["Tg"])
    return {k: np.asarray(v) for k, v in out.items()}


def test_losses_match_jax_shard_map(tmp_path):
    """The EVD, SVD and CDK losses and their input gradients with a dp=2
    group against JAX's shard_map dp=2 on the same per-rank rows: each
    rank's loss is the global one, its gradients its rows of the global
    gradient (the backward divides by the global batch)."""
    z = _loss_inputs(np.random.default_rng(0))
    np.savez(tmp_path / "inputs.npz", **z)
    want = _jax_losses(z)
    d = workers.run_ranks(workers.losses_rank, tmp_path, str(tmp_path / "inputs.npz"))
    for r, got in enumerate(_outs(d)):
        for k, w in want.items():
            if "loss" in k:
                np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_allclose(got[k], _rows(w, r), rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} {k}")


# -- the methods ------------------------------------------------------------------

# (method, per-mode towers, options) on ``weighted_operator`` (a radial
# weight times f; a Laplacian's compile under shard_map takes JAX ~20-70 s
# a case): NeuralEF with its batch norm (the default "unbiased" mode)
METHOD_CASES = {
    "neuralef": ("neuralef", True, {}),
    "neuralef-trunk": ("neuralef", False, {"unbiased": True}),
    "spin": ("spin", True, {"decay": 0.3}),
    "spinx": ("spinx", True, {"decay": 0.3}),
}
# (rtol, atol in units of the largest entry): NeuralEF's parity tests'
# (tests/test_torch_neuralef.py: the two packages' float64 FD gradients
# differ by up to ~3e-6 relative on a single process too), the SpIN tests'
TOLERANCE = {"neuralef": (1e-4, 1e-6), "spin": (1e-6, 1e-9), "spinx": (1e-6, 1e-9)}


def _mclose(got, want, what, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-300), err_msg=what)


def _jax_weighted(f, x, importance=None):
    fs = f(x)
    return jnp.exp(-jnp.sum(x ** 2, -1, keepdims=True)) * fs, fs


def _jax_method(case, spec, x):
    """(init params as float32 numpy, loss, per-device grads and new state
    stacked on a leading axis of 2) of JAX's method with axis_name "dp"
    mapped over the two halves of ``x``."""
    name, parallel, opts = spec
    kw = dict(workers.METHOD_MODEL, parallel=parallel)
    jinit, japply = jax_make_wavefunctions(**kw)
    params32 = jax.tree.map(np.asarray, jinit(jax.random.key(len(case))))
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params32)
        jm = jax_get_evd_method(name, japply, L, axis_name="dp", **opts)
        state = jm.init_state(jp)

        def per_device(p, s, xx):
            loss, grads, _, new = jm.loss_and_grad(p, s, xx, _jax_weighted, None)
            return loss, grads, new

        # vmap over the two devices' rows with the named axis "dp": the
        # values of shard_map(check_vma=False) bit for bit on these cases,
        # in a fifth of its compile time
        fn = jax.vmap(per_device, in_axes=(None, None, 0), axis_name="dp")
        loss, grads, new = fn(jp, state, jnp.asarray(x).reshape(2, -1, x.shape[1]))
        return params32, np.asarray(loss[0]), jax.tree.map(np.asarray, grads), \
            jax.tree.map(np.asarray, new)


def test_methods_match_jax_named_axis(tmp_path):
    """NeuralEF (batch norm on: the norm averaged over the ranks inside the
    differentiated model), SpIN and SpINx ``loss_and_grad`` with a dp=2
    group against JAX's methods with ``axis_name="dp"`` in shard_map, on
    the same per-rank batches and parameters: the loss, each rank's
    gradients and each rank's new state."""
    rng = np.random.default_rng(1)
    inputs, want = {}, {}
    for case, spec in METHOD_CASES.items():
        x = rng.choice((0.5, 2.0, 6.0), size=(2 * B, 1)) * rng.normal(size=(2 * B, 2))
        inputs[f"{case}/x"] = x
        params32, *want[case] = _jax_method(case, spec, x)
        for k, v in params_from_jax(params32).items():
            inputs[f"{case}/param/{k}"] = v.numpy()
    np.savez(tmp_path / "inputs.npz", **inputs)
    d = workers.run_ranks(workers.methods_rank, tmp_path, str(tmp_path / "inputs.npz"),
                          METHOD_CASES)
    for r, got in enumerate(_outs(d)):
        for case, (loss, grads, new) in want.items():
            tol = TOLERANCE[METHOD_CASES[case][0]]
            _mclose(got[f"{case}/loss"], loss, f"rank {r} {case} loss", (1e-5, 0))
            for k, g in _named_leaves(jax.tree.map(lambda a: a[r], grads)):
                _mclose(got[f"{case}/grad/{k}"], g, f"rank {r} {case} grad {k}", tol)
            per_mode = (make_wavefunctions(**dict(workers.METHOD_MODEL, parallel=True),
                                           device="cpu").per_mode_parameters()
                        if case == "spin" else ())
            state = method_state_from_jax(jax.tree.map(lambda a: a[r], new), per_mode,
                                          dtype=torch.float64)
            for k, v in workers._flat(state):
                _mclose(got[f"{case}/state/{k}"], v.numpy(), f"rank {r} {case} state {k}",
                        tol)
        # the forward engine's duals through the batch norm's mean: on
        # the same rows on both ranks the group changes nothing
        for k in got:
            if k.startswith("forward-dp/"):
                ref = got["forward-single/" + k[len("forward-dp/"):]]
                np.testing.assert_allclose(got[k], ref, rtol=1e-12, atol=1e-14, err_msg=k)
        assert any(k.startswith("forward-dp/grad/") for k in got)


# -- the dp train steps -----------------------------------------------------------

def _half_consistent_union(xs):
    """The single-process batch of the dp ranks' local batches: all local
    first halves, then all local second halves (tests/test_parallel.py)."""
    h = xs[0].shape[0] // 2
    return np.concatenate([x[:h] for x in xs] + [x[h:] for x in xs])


def test_dp_train_step_matches_the_single_process_step(tmp_path):
    """``make_mesh_train_step`` dp=2 (gradients SUMMED over the ranks, not
    averaged) against the port's single-process step on the half-consistent
    union, plain and with a grad clip that bites: the loss, the global
    gradient norm before the clip, and the parameters after one SGD step
    (an update linear in the gradient, so its scale shows); a batch with a
    NaN row on one rank makes both ranks skip.  The refusals that need a
    group: a method without it, a step without the method's, use_pallas=True
    with one ("auto" takes the plain loss), a CUDA graph on gloo."""
    rng = np.random.default_rng(2)
    inputs = {}
    for case in workers.TRAIN_CASES:
        for r in range(2):
            x = rng.normal(size=(B, 2)).astype(np.float32)
            if case == "nonfinite" and r == 1:
                x[3] = np.nan
            inputs[f"{case}/x{r}"] = x
    np.savez(tmp_path / "inputs.npz", **inputs)
    d = workers.run_ranks(workers.train_step_rank, tmp_path, str(tmp_path / "inputs.npz"))
    outs = _outs(d)
    gnorm = {}
    for case, kw in workers.TRAIN_CASES.items():
        model, opt = workers.evd_setup()
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        method = NestedLoRA(model, L, sequential=True)
        X = torch.tensor(_half_consistent_union([inputs[f"{case}/x{r}"] for r in range(2)]))
        step = make_train_step(method, workers.weighted_operator, opt, lambda g: X,
                               ema_decay=0.9, **kw)
        ts = init_train_state(model, opt, method)
        _, metrics = step(ts, torch.Generator())
        gnorm[case] = metrics["gnorm"].item()
        for r, got in enumerate(outs):
            if case == "nonfinite":
                assert got[f"{case}/skipped"] and not np.isfinite(got[f"{case}/loss"])
                for k, p in init.items():
                    np.testing.assert_array_equal(got[f"{case}/param/{k}"], p.numpy())
                continue
            assert not got[f"{case}/skipped"]
            np.testing.assert_allclose(got[f"{case}/loss"], metrics["loss"].item(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"rank {r} {case}")
            np.testing.assert_allclose(got[f"{case}/gnorm"], gnorm[case], rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r} {case} gnorm")
            for k, p in ts.params.items():
                np.testing.assert_allclose(got[f"{case}/param/{k}"], p.detach().numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {case} {k}")
    assert workers.TRAIN_CASES["clip"]["grad_clip"] < gnorm["clip"]


@pytest.mark.parametrize("grad_clip", [0.0, 0.05])
def test_dp_cdk_step_matches_the_single_process_step(tmp_path, grad_clip):
    """``make_mesh_cdk_step`` dp=2, three steps on each rank's half of the
    pairs, against ``make_cdk_train_step`` on the whole batch: loss, its
    two parts, the parameters, and aux's f/g gathered in global order."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2 * B, 6)).astype(np.float32)
    y = x + 0.1 * rng.normal(size=(2 * B, 6)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", x=x, y=y)
    d = workers.run_ranks(workers.cdk_step_rank, tmp_path, str(tmp_path / "inputs.npz"),
                          grad_clip)
    model, opt = workers.cdk_setup()
    step = make_cdk_train_step(NestedLoRAForCDK(model, 4), opt, grad_clip)
    params = dict(model.named_parameters())
    state, skips = opt.init(params), torch.zeros((), dtype=torch.int32)
    for _ in range(workers.CDK_STEPS):
        params, state, _, loss, aux, skips = step(params, state, {}, torch.tensor(x),
                                                  torch.tensor(y), skips)
    for r, got in enumerate(_outs(d)):
        for k, want in (("loss", loss), ("loss_operator", aux["loss_operator"]),
                        ("loss_metric", aux["loss_metric"])):
            np.testing.assert_allclose(got[k], want.item(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        assert int(got["skips"]) == 0
        for k in ("f", "g"):
            np.testing.assert_allclose(got[k], aux[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} aux {k}")
        for k, p in params.items():
            np.testing.assert_allclose(got[f"param/{k}"], p.detach().numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
