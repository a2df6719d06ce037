"""NestedLoRA (NeuralSVD) for self-adjoint operators — the EVD path.

Port of ``neuralsvd_tpu/methods/nestedlora.py:59-127`` (``NestedLoRA``, the
operator path).  The model is an ``nn.Module``; parameters travel as a
name -> tensor dict and the model is applied with
``torch.func.functional_call``, the counterpart of JAX's
``apply_fn(params, x)``, so EMA parameters evaluate the same module.

Loss route (``use_pallas``, parsed like the JAX flag): "auto" (default)
sends (B, L) outputs on a CUDA device through the hand-written kernels of
ops/cuda_gram.py and everything else through the plain path; True always
takes the kernel packaging (whose wrappers use their plain versions on
the CPU); False always takes the plain path.  (B, L, O) outputs always
take the plain path.  The JAX package's "auto" -> False was a TPU
measurement and is not inherited.

Not ported yet (ROADMAP queue 1, item 7): the kernel-operator path
(``loss_and_grad_kernel``) and ``NestedLoRAForCDK``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from neuralsvd_tpu_torch.ops.cuda_gram import nestedlora_evd_loss_kernels
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_evd_loss


def _build_masks(neigs: int, step: int, sequential: bool):
    if sequential:
        return sequential_nesting_masks(neigs)
    return joint_nesting_masks(step_weights(neigs, step))


def _resolve_use_pallas(use_pallas):
    if isinstance(use_pallas, str):
        use_pallas = {"auto": "auto", "true": True, "false": False,
                      "1": True, "0": False}[use_pallas.lower()]
    return use_pallas if use_pallas == "auto" else bool(use_pallas)


class NestedLoRA:
    """NeuralSVD via nested low-rank approximation (EVD operator path).

    ``sort_indices`` (set by ``register_eigvals``) reorders the model
    outputs during training so nesting weights track the spectrum order.
    """

    name = "nestedlora"

    def __init__(self, model: nn.Module, neigs: int, step: int = 1,
                 sequential: bool = False, use_pallas="auto"):
        self.model = model
        self.neigs = neigs
        self.use_pallas = _resolve_use_pallas(use_pallas)
        self._np_masks = _build_masks(neigs, step, sequential)
        self._masks: Dict[torch.device, tuple] = {}
        self.sort_indices: Optional[np.ndarray] = None
        self.eigvals: Optional[np.ndarray] = None

    def masks(self, device) -> tuple:
        """(vector_mask (L,), matrix_mask (L, L)) as float32 on ``device``."""
        device = torch.device(device)
        if device not in self._masks:
            self._masks[device] = tuple(
                torch.as_tensor(m, device=device) for m in self._np_masks)
        return self._masks[device]

    def _evd_loss(self, fs, Tf, f1, f2):
        vector_mask, matrix_mask = self.masks(fs.device)
        kernels = (self.use_pallas is True
                   or (self.use_pallas == "auto" and fs.is_cuda))
        if kernels and fs.ndim == 2:
            return nestedlora_evd_loss_kernels(fs, Tf, f1, f2, vector_mask,
                                               matrix_mask)
        return nestedlora_evd_loss(fs, Tf, f1, f2, vector_mask, matrix_mask)

    def register_eigvals(self, eigvals):
        self.eigvals = np.asarray(eigvals)
        self.sort_indices = np.argsort(self.eigvals)[::-1].copy()

    def init_state(self, params):
        return {}

    def _model(self, params) -> Callable:
        if self.sort_indices is not None:
            idx = torch.as_tensor(self.sort_indices)
            return lambda x: functional_call(self.model, params, (x,))[:, idx.to(x.device)]
        return lambda x: functional_call(self.model, params, (x,))

    def eval_apply(self, params, state, x):
        return functional_call(self.model, params, (x,))

    def loss_and_grad(self, params, state, x, operator, importance=None):
        """(loss, grads {name: tensor}, aux {f, Tf, eigvals}, state).

        ``fs`` is made contiguous before it is split into the half-batches
        f1/f2 (contiguous row views), as the kernels require.
        """
        f = self._model(params)
        Tf, fs = operator(f, x, importance)
        if fs.shape[0] % 2:
            raise ValueError("the batch must split into two equal halves")
        fs = fs.contiguous()
        Tf = Tf.contiguous()
        f1, f2 = torch.chunk(fs, 2)
        loss = self._evd_loss(fs, Tf, f1, f2)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        return (loss.detach(), dict(zip(names, grads)),
                dict(f=fs.detach(), Tf=Tf, eigvals=None), state)
