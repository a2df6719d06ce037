"""Serving export: evaluators that load from one file, at any batch size.

Port of ``neuralsvd_tpu/utils/export.py:1-43`` on ``torch.export``: a
trained model's evaluator ``x (b, input_dim) -> apply_fn(params, x)`` is
traced once with a dynamic batch dimension (``torch.export.Dim``) into an
``ExportedProgram`` whose parameters (and the model's buffers, such as the
Fourier matrix) are saved with it, so a serving process loads one ``.pt2``
file and evaluates at any batch size without the model's Python code, its
checkpoints or a retrace.  The two serving surfaces are the JAX package's:
a wavefunction's Ψ(x) (``functional_call(model, params, (x,))``) and a CDK
tower's embedding (``model.apply_single(x, "x")`` or ``model(x, x)[0]``).

A model that does not trace raises (``torch.export`` names the op): there
is no fallback to eager or to pickling the module.  The program runs on
the device of the parameters it was exported with.  A tower product at a
``--matmul_precision`` tier on the card runs under cuBLAS's TF32 switch, a
global setting that no traced graph records: the program holds it as one
operator, ``neuralsvd_tpu_torch::tiered_einsum`` (models/mlp.py), which
sets the switch around its product as the eager module does; importing
this module registers it.
"""
from __future__ import annotations

import io
from typing import Callable, Dict

import torch
from torch import nn

from neuralsvd_tpu_torch.models import mlp  # noqa: F401  (registers tiered_einsum)

__all__ = ["export_evaluator", "load_evaluator", "load_evaluator_file", "save_evaluator"]

MIN_EXAMPLE_BATCH = 2  # torch.export specializes a dimension traced at 0 or 1


class _Evaluator(nn.Module):
    """``apply_fn(params, x)`` with ``params`` held as buffers, so that the
    exported program carries them."""

    def __init__(self, apply_fn: Callable, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.apply_fn = apply_fn
        self.names = list(params)
        for i, name in enumerate(self.names):
            self.register_buffer(f"param_{i}", params[name].detach().clone())

    def forward(self, x):
        params = {name: getattr(self, f"param_{i}") for i, name in enumerate(self.names)}
        return self.apply_fn(params, x)


def _program(apply_fn, params, input_dim: int, dtype) -> torch.export.ExportedProgram:
    params = dict(params)
    device = next(iter(params.values())).device if params else torch.device("cpu")
    evaluator = _Evaluator(apply_fn, params)
    example = torch.zeros((MIN_EXAMPLE_BATCH + 1, input_dim), dtype=dtype, device=device)
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        return torch.export.export(evaluator, (example,), dynamic_shapes=({0: batch},))


def export_evaluator(apply_fn: Callable, params: Dict[str, torch.Tensor], input_dim: int,
                     dtype=torch.float32) -> bytes:
    """The bytes of the ``torch.export`` program of ``x (b, input_dim) ->
    apply_fn(params, x)`` with a dynamic batch dimension; ``params`` (a
    name -> tensor dict, on one device) are baked in."""
    buf = io.BytesIO()
    torch.export.save(_program(apply_fn, params, input_dim, dtype), buf)
    return buf.getvalue()


def load_evaluator(blob: bytes) -> Callable:
    """An ``export_evaluator`` program as a callable ``x -> output``."""
    return torch.export.load(io.BytesIO(blob)).module()


def save_evaluator(path: str, apply_fn: Callable, params: Dict[str, torch.Tensor],
                   input_dim: int, dtype=torch.float32) -> None:
    """``export_evaluator`` into the file ``path`` (a ``.pt2``)."""
    torch.export.save(_program(apply_fn, params, input_dim, dtype), path)


def load_evaluator_file(path: str) -> Callable:
    """A ``save_evaluator`` file as a callable ``x -> output``."""
    with open(path, "rb") as fh:
        return load_evaluator(fh.read())
