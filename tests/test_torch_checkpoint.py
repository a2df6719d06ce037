"""The checkpoint API of the validation harnesses: ``save_resumable``,
``load_resumable`` and ``load_pretrained`` (port of
``neuralsvd_tpu/training/checkpoint.py:41-155``).

The round trip gives the state back bit for bit into a fresh template and
a missing path gives None; a corrupt or truncated file raises (the
recorded departure from JAX, which warns and returns None, ROADMAP §3).
``load_pretrained`` unwraps ``params``, ``ema_params`` and ``model``,
strips the ``module.`` and ``backbone.`` prefixes, ignores extra entries
and raises on a missing one, as JAX's does.
"""
import os

import numpy as np
import pytest
import torch

from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.methods.spin import SpIN
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.training.checkpoint import (
    load_pretrained,
    load_resumable,
    save_checkpoint,
    save_resumable,
)
from neuralsvd_tpu_torch.training.optimizers import torch_rmsprop
from neuralsvd_tpu_torch.training.train_operator import make_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state, state_tree
from neuralsvd_tpu_torch.utils import config

L = 3
TINY = dict(ndim=2, neigs=L, mlp_hidden_dims=[8, 8], nonlinearity="softplus",
            parallel=True, use_fourier_feature=True, fourier_mapping_size=4,
            fourier_scale=0.1, apply_boundary=False)


def _trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    return a == b


def _spin_state(seed, steps):
    """A SpIN TrainState after ``steps`` steps of a matrix-free toy
    operator (Tf = 2f), so every field (RMSprop ν, EMA, j_avg) has moved."""
    model = make_wavefunctions(**TINY, seed=seed, device="cpu")
    method = SpIN(model, L, decay=0.2)
    opt = torch_rmsprop(1e-3)
    ts = init_train_state(model, opt, method)
    gen = torch.Generator().manual_seed(seed)

    def operator(f, x, importance=None, with_graph=False):
        fs = f(x)
        return 2.0 * fs, fs

    step = make_train_step(method, operator, opt, lambda g: torch.randn(16, 2, generator=g))
    for _ in range(steps):
        step(ts, gen)
    return ts


def test_resumable_round_trip_is_bit_for_bit(tmp_path):
    """save_resumable then load_resumable into a fresh template: every
    tensor equal bit for bit, the chunk back, the template's own tensors
    written (not replaced); a missing path gives None."""
    ts = _spin_state(0, 3)
    path = str(tmp_path / "snap.pt")
    assert save_resumable(path, ts, chunk=7) == os.path.abspath(path)
    template = _spin_state(1, 0)
    ptr = template.params["base.ws.0"].data_ptr()
    got, chunk = load_resumable(path, template)
    assert got is template and chunk == 7
    assert template.params["base.ws.0"].data_ptr() == ptr
    assert _trees_equal(state_tree(template), state_tree(ts))
    assert load_resumable(str(tmp_path / "missing.pt"), template) is None


@pytest.mark.parametrize("damage", ["truncated", "garbage"])
def test_corrupt_resumable_raises(tmp_path, damage):
    """A truncated or overwritten snapshot raises, where JAX warns and
    returns None (a recorded departure); the template is left alone."""
    ts = _spin_state(2, 1)
    path = tmp_path / "snap.pt"
    save_resumable(str(path), ts, chunk=1)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2] if damage == "truncated" else b"\0" * len(data))
    template = _spin_state(3, 0)
    before = state_tree(template)
    with pytest.raises((RuntimeError, OSError)):  # torch's zip reader raises either
        load_resumable(str(path), template)
    assert _trees_equal(state_tree(template), before)


def test_load_pretrained_unwraps_and_strips(tmp_path):
    """A TrainState tree gives its params (the first of JAX's keys), or
    its EMA with keys=("ema_params",); a state dict under "model" with
    DataParallel's "module." and a "backbone." prefix, plus extra entries,
    gives the parameters; a missing entry raises KeyError, a wrong shape
    ValueError; the tensors come back in the template's dtype."""
    ts = _spin_state(4, 2)
    template = {k: torch.zeros_like(p) for k, p in ts.params.items()}
    path = str(tmp_path / "ts.pt")
    save_checkpoint(path, state_tree(ts))
    assert _trees_equal(load_pretrained(path, template), state_tree(ts)["params"])
    ema = load_pretrained(path, template, keys=("ema_params",))
    assert _trees_equal(ema, state_tree(ts)["ema_params"])
    assert not _trees_equal(ema, state_tree(ts)["params"])

    wrapped = {"model": {f"module.backbone.{k}" if i % 2 else f"module.{k}": p.detach().clone()
                         for i, (k, p) in enumerate(ts.params.items())}}
    wrapped["model"]["module.head.w"] = torch.ones(3)
    save_checkpoint(path, wrapped)
    assert _trees_equal(load_pretrained(path, template), state_tree(ts)["params"])
    as64 = load_pretrained(path, {k: v.double() for k, v in template.items()})
    assert all(v.dtype == torch.float64 for v in as64.values())

    missing = dict(template, **{"base.extra": torch.zeros(2)})
    with pytest.raises(KeyError):
        load_pretrained(path, missing)
    bad = dict(template)
    bad["base.ws.0"] = torch.zeros(1, 1, 1)
    with pytest.raises(ValueError, match="base.ws.0"):
        load_pretrained(path, bad)


def test_load_pretrained_reads_a_cli_checkpoint(tmp_path):
    """The EMA parameters of a PDE CLI run's ckpt_<it>, loaded into a fresh
    model, give the run's own EMA model outputs bit for bit."""
    cfg = config.PDEConfig(log_dir=str(tmp_path), device="cpu", seed=1, neigs=L,
                           mlp_hidden_dims="8,8", batch_size=16, lim=2.0, val_eps=0.5,
                           num_iters=2, print_freq=2, eval_freq=2, parallel=True,
                           apply_boundary=False, use_fourier_feature=True,
                           fourier_mapping_size=4, fourier_scale=0.1, laplacian_eps=0.01)
    ts, _, _ = pde.main(cfg)
    ckpt = next(p for p in tmp_path.rglob("ckpt_2"))
    model = pde.build(cfg).model
    params = dict(model.named_parameters())
    loaded = load_pretrained(str(ckpt), params, keys=("ema_params",))
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(loaded[k])
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 2)), dtype=torch.float32)
    run_model = pde.build(cfg).model
    with torch.no_grad():
        for k, p in run_model.named_parameters():
            p.copy_(ts.ema_params[k])
        assert torch.equal(model(x), run_model(x))
