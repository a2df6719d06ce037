"""Entry points of the port: a compile check of the flagship model, and a
multi-rank dryrun of the mesh training paths.

Counterpart of the JAX package's ``__graft_entry__.py:24-220``.
``entry()`` returns ``(fn, example_args)``: the flagship 2D hydrogen
wavefunction (L 36, Fourier features, per-mode 128³ softplus towers, the
box mask at lim 32) and a batch of 512 points, on the card unless
``device`` says otherwise.

``dryrun_multichip(n)`` runs one dp x tp PDE train step (NestedLoRA on
ParallelMLP towers, the modes sharded over tp) and one dp CDK step on ``n``
gloo ranks on the CPU (``parallel.launch.run_ranks``), always in a
subprocess with a hard timeout: the caller's process may hold a CUDA
context or a process group of its own, and is never asked what devices it
has (the subprocess hides the cards).  A failed or timed-out child raises
RuntimeError with the end of its output.

    python -m neuralsvd_tpu_torch.graft_entry [--dryrun N]
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.func import functional_call

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Hard wall for the guarded dryrun subprocess: the dryrun takes ~10-30 s on
# gloo CPU ranks; this bounds a wedged child well inside any caller's limit.
_DRYRUN_TIMEOUT_S = 600
_RANK_TIMEOUT_S = 300


def _flagship_model(neigs=36, ndim=2, device="cuda"):
    """2D hydrogen flagship: Fourier features -> per-mode towers -> box mask."""
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions

    return make_wavefunctions(
        ndim=ndim, neigs=neigs, mlp_hidden_dims=[128, 128, 128],
        nonlinearity="softplus", parallel=True, use_fourier_feature=True,
        fourier_mapping_size=256, fourier_scale=0.1, fourier_append_radial=True,
        apply_boundary=True, boundary_mode="dir_box_sqrt", lim=32.0, device=device)


def entry(device="cuda"):
    """(fn, example_args): ``fn(params, x)`` the flagship model's forward
    on ``params`` (a name -> tensor dict) and ``x`` (512, 2)."""
    model = _flagship_model(device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    x = torch.zeros((512, 2), device=params["base.ws.0"].device) + 0.5

    def fn(params, x):
        return functional_call(model, params, (x,))

    return fn, (params, x)


def dryrun_multichip(n_devices: int) -> None:
    """Validate the mesh training paths on ``n_devices`` gloo CPU ranks, in
    a guarded subprocess (module docstring); raises RuntimeError on the
    child's failure or timeout."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # CPU ranks; the caller's cards stay its own
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "neuralsvd_tpu_torch.graft_entry", "--dryrun",
             str(n_devices)], env=env, cwd=_ROOT, capture_output=True, text=True,
            timeout=_DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        out = e.stdout or b""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        raise RuntimeError(f"dryrun_multichip subprocess timed out after "
                           f"{_DRYRUN_TIMEOUT_S}s:\n{out[-2000:]}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun_multichip subprocess failed (rc={proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def _dryrun_mesh(n_devices: int) -> str:
    """The dp x tp mesh of the dryrun: tp=2 where ``n_devices`` is even."""
    return f"dp={n_devices // 2},tp=2" if n_devices % 2 == 0 else f"dp={n_devices}"


def _dryrun_rank(rank, d, n_devices):
    """One rank of the dryrun: the PDE step on the dp x tp mesh and the CDK
    step on a dp mesh of every rank, each checked."""
    from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA, NestedLoRAForCDK
    from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork
    from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
    from neuralsvd_tpu_torch.operators.problems import get_problem
    from neuralsvd_tpu_torch.parallel.mesh import dp_group, local_rows, make_mesh, tp_group
    from neuralsvd_tpu_torch.parallel.sharding import (
        make_mesh_cdk_step,
        make_mesh_train_step,
        mode_shards,
        shard_module,
    )
    from neuralsvd_tpu_torch.training.optimizers import build_optimizer, torch_rmsprop
    from neuralsvd_tpu_torch.training.train_state import init_train_state

    L, ndim = 8, 2
    mesh = make_mesh(_dryrun_mesh(n_devices), device="cpu")
    dp, tp = dp_group(mesh), tp_group(mesh)
    model = make_wavefunctions(ndim=ndim, neigs=L, mlp_hidden_dims=[16, 16],
                               nonlinearity="softplus", parallel=True, apply_boundary=False,
                               seed=0, device="cpu")
    shards = mode_shards(model, tp, L)
    local = model if shards is None else shard_module(model, shards)
    operator, _, _ = get_problem("sch", "hydrogen", ndim, L, laplacian_eps=0.1,
                                 operator_scale=1.0, operator_shift=2.0)
    method = NestedLoRA(local, L, sequential=True, axis_name=dp, mode_axis=tp)
    opt = torch_rmsprop(1e-4)
    batch = 16 * n_devices
    x = 4.0 * torch.randn((batch, ndim), generator=torch.Generator().manual_seed(1))
    step = make_mesh_train_step(method, operator, opt, lambda g: x, mesh, shards)
    ts = init_train_state(local, opt, method)
    _, metrics = step(ts, torch.Generator())
    assert torch.isfinite(metrics["loss"]), f"non-finite loss in dryrun: {metrics['loss']}"
    assert int(ts.step) == 1
    if shards is not None:  # the modes really are sharded
        assert ts.params["base.ws.0"].shape[0] == L // 2, ts.params["base.ws.0"].shape

    cdk_mesh = make_mesh(f"dp={n_devices}", device="cpu")
    group = dp_group(cdk_mesh)
    dim = 8
    net = HeteroNetwork(dim, [16, 4], "lrelu0.2", mu=16.0, regularize_mode="l2_ball",
                        generator=torch.Generator().manual_seed(0))
    cdk = NestedLoRAForCDK(net, 4, axis_name=group)
    sgd = build_optimizer("sgd", 1e-3)
    params = dict(net.named_parameters())
    B = 8 * n_devices
    gen = torch.Generator().manual_seed(2)
    xs = torch.randn((B, dim), generator=gen)
    ys = xs + 0.1 * torch.randn((B, dim), generator=gen)
    cdk_step = make_mesh_cdk_step(cdk, sgd, cdk_mesh)
    _, _, _, loss, aux, _ = cdk_step(params, sgd.init(params), {}, local_rows(xs, group),
                                     local_rows(ys, group), torch.zeros((), dtype=torch.int32))
    assert torch.isfinite(loss), "non-finite CDK dryrun loss"
    assert aux["f"].shape == (B, 4), aux["f"].shape
    np.save(os.path.join(d, f"ok.{rank}.npy"), np.array([metrics["loss"].item(), loss.item()]))


def _dryrun_multichip_impl(n_devices: int) -> None:
    """Run ``_dryrun_rank`` on ``n_devices`` gloo CPU ranks."""
    from neuralsvd_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        d = run_ranks(_dryrun_rank, tmp, n_devices, world=n_devices,
                      timeout=_RANK_TIMEOUT_S)
        losses = [np.load(os.path.join(d, f"ok.{r}.npy")) for r in range(n_devices)]
    assert all(np.array_equal(v, losses[0]) for v in losses), losses


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--dryrun":
        n = int(sys.argv[2])
        _dryrun_multichip_impl(n)
        print(f"dryrun ok ({n} ranks, mesh {_dryrun_mesh(n)})")
        sys.exit(0)
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(8)
    print("dryrun ok")
