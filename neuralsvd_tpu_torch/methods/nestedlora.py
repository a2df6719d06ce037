"""NestedLoRA (NeuralSVD): the EVD operator path and the CDK two-tower path.

Port of ``neuralsvd_tpu/methods/nestedlora.py:59-146`` (``NestedLoRA``, the
operator path and the kernel-operator path) and ``:148-196``
(``NestedLoRAForCDK``).  The model is an
``nn.Module``; parameters travel as a name -> tensor dict and the model is
applied with ``torch.func.functional_call``, the counterpart of JAX's
``apply_fn(params, x)``, so EMA parameters evaluate the same module.

Loss route (``use_pallas``, parsed like the JAX flag): "auto" (default)
sends (B, L) outputs on a CUDA device through the hand-written kernels of
ops/cuda_gram.py (the EVD or the CDK packaging) and everything else
through the plain path; True always takes the kernel packaging (whose
wrappers use their plain versions on the CPU); False always takes the
plain path.  (B, L, O) outputs always
take the plain path.  The JAX package's "auto" -> False was a TPU
measurement and is not inherited: on an NVIDIA H100 80GB HBM3 (700 W), the
CDK step at the Sketchy width ran 104.3-104.5 steps/s through the kernels
against 103.4-103.6 through the plain path, in turns in one process
(profile_torch_e4.py --path cdk), and the E4 step is host bound either
way.

The kernel-operator path (``loss_and_grad_kernel``) goes through the same
``_evd_loss``, so K1-K3 run on it too: without ``split_batch`` at (B, L)
as on the operator path; with it the loss is ``_evd_loss(f1, Kf1, f1, f2)``
(x1's values against x2 as landmarks), so K2 sees the (B/2, L) pair (f1,
Kf1).

``axis_name`` (a data-parallel process group, parallel/collectives.py, or
None) goes to the plain losses, whose grams and operator term are then
averaged over the group's ranks (JAX's ``_resolve_use_pallas`` :35-56):
"auto" with a group takes the plain loss, and True with a group raises
``ValueError``, since a kernel packaging has no place for the all-reduce
between its gram pass and its masked sum.

``mode_axis`` (a tp process group, or None): ``model`` is then a rank's
share of the modes (parallel/sharding.py ``shard_module``) and
``loss_and_grad`` all-gathers the f and Tf the operator returns for those
modes (``parallel.collectives.gather_modes``) before the loss, which sees
all L modes, as GSPMD gathers them for the JAX package; the gather sits
outside the operator, so no forward-Laplacian dual meets a collective.
With ``axis_name`` None the loss on the gathered (B, L) takes K1-K3 on the
card, once a step on each rank.  A sort (``register_eigvals``) permutes
the gathered modes.  The CDK method needs no such axis: a sharded
two-tower network gathers its own modes before its row norm.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from neuralsvd_tpu_torch.ops.cuda_gram import (
    nestedlora_cdk_loss_kernels,
    nestedlora_evd_loss_kernels,
)
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.ops.nestedlora import (
    nestedlora_cdk_loss,
    nestedlora_evd_loss,
)
from neuralsvd_tpu_torch.parallel.collectives import gather_modes


def _build_masks(neigs: int, step: int, sequential: bool,
                 set_first_mode_const: bool = False):
    if sequential:
        return sequential_nesting_masks(neigs, set_first_mode_const)
    return joint_nesting_masks(step_weights(neigs, step), set_first_mode_const)


def _device_masks(np_masks, cache: dict, device) -> tuple:
    """(vector_mask, matrix_mask) as float32 on ``device``, made once."""
    device = torch.device(device)
    if device not in cache:
        cache[device] = tuple(torch.as_tensor(m, device=device)
                              for m in np_masks)
    return cache[device]


def _use_kernels(use_pallas, t: torch.Tensor) -> bool:
    return use_pallas is True or (use_pallas == "auto" and t.is_cuda)


def _resolve_use_pallas(use_pallas, axis_name=None):
    if isinstance(use_pallas, str):
        use_pallas = {"auto": "auto", "true": True, "false": False,
                      "1": True, "0": False}[use_pallas.lower()]
    if axis_name is not None:
        if use_pallas is True:
            raise ValueError("use_pallas=True is incompatible with axis_name "
                             "(data parallelism); use the plain path")
        return False
    return use_pallas if use_pallas == "auto" else bool(use_pallas)


class NestedLoRA:
    """NeuralSVD via nested low-rank approximation (EVD operator path).

    ``sort_indices`` (set by ``register_eigvals``) reorders the model
    outputs during training so nesting weights track the spectrum order.
    """

    name = "nestedlora"

    def __init__(self, model: nn.Module, neigs: int, step: int = 1,
                 sequential: bool = False, sort: bool = False,
                 axis_name=None, use_pallas="auto", mode_axis=None):
        self.model = model
        self.neigs = neigs
        self.sort = sort  # read by callers, as in the JAX package
        self.axis_name = axis_name
        self.mode_axis = mode_axis
        self.use_pallas = _resolve_use_pallas(use_pallas, axis_name)
        self._np_masks = _build_masks(neigs, step, sequential)
        self._masks: Dict[torch.device, tuple] = {}
        self.sort_indices: Optional[np.ndarray] = None
        self.eigvals: Optional[np.ndarray] = None

    def masks(self, device) -> tuple:
        """(vector_mask (L,), matrix_mask (L, L)) as float32 on ``device``."""
        return _device_masks(self._np_masks, self._masks, device)

    def _evd_loss(self, fs, Tf, f1, f2):
        vector_mask, matrix_mask = self.masks(fs.device)
        if _use_kernels(self.use_pallas, fs) and fs.ndim == 2:
            return nestedlora_evd_loss_kernels(fs, Tf, f1, f2, vector_mask,
                                               matrix_mask)
        return nestedlora_evd_loss(fs, Tf, f1, f2, vector_mask, matrix_mask,
                                   self.axis_name)

    def register_eigvals(self, eigvals):
        self.eigvals = np.asarray(eigvals)
        self.sort_indices = np.argsort(self.eigvals)[::-1].copy()

    def init_state(self, params):
        return {}

    def _model(self, params) -> Callable:
        if self.sort_indices is not None and self.mode_axis is None:
            idx = torch.as_tensor(self.sort_indices)
            return lambda x: functional_call(self.model, params, (x,))[:, idx.to(x.device)]
        return lambda x: functional_call(self.model, params, (x,))

    def _modes(self, t):
        """All L modes of a rank's share ``t`` under ``mode_axis`` (then
        sorted), ``t`` itself without one."""
        if self.mode_axis is None:
            return t
        t = gather_modes(t, self.mode_axis, self.neigs)
        if self.sort_indices is not None:
            t = t[:, torch.as_tensor(self.sort_indices).to(t.device)]
        return t

    def eval_apply(self, params, state, x):
        return functional_call(self.model, params, (x,))

    def loss_and_grad(self, params, state, x, operator, importance=None):
        """(loss, grads {name: tensor}, aux {f, Tf, eigvals}, state).

        ``fs`` is made contiguous before it is split into the half-batches
        f1/f2 (contiguous row views), as the kernels require.
        """
        Tf, fs = operator(self._model(params), x, importance)
        return self._loss_and_grad(params, state, self._modes(fs), self._modes(Tf))

    def loss_and_grad_kernel(self, params, state, x, get_approx_kernel_op,
                             importance=None, split_batch: bool = False):
        """The kernel-operator path: ``get_approx_kernel_op(landmarks)`` is
        an operator (``operators.base.KernelOperator``).  Without
        ``split_batch`` the batch is its own landmarks; with it the first
        half's values and their smoothing over the second half (Kf1) make
        the operator term, and the halves (f1, f2) the metric term.
        Returns as ``loss_and_grad``, aux {f: f1, Tf: Kf1} when split."""
        f = self._model(params)
        if not split_batch:
            Tf, fs = get_approx_kernel_op(x)(f, x, importance)
            return self._loss_and_grad(params, state, self._modes(fs), self._modes(Tf))
        if x.shape[0] % 2:
            raise ValueError("the batch must split into two equal halves")
        x1, x2 = torch.chunk(x, 2)
        Kf1, f1 = get_approx_kernel_op(x2)(f, x1, importance)
        return self._loss_and_grad(params, state, self._modes(f1), self._modes(Kf1),
                                   f2=self._modes(f(x2)))

    def _loss_and_grad(self, params, state, fs, Tf, f2=None):
        """The EVD loss on (fs, Tf) with the halves of fs, or with (fs, f2)
        as the halves where ``f2`` is given, and its gradients."""
        if f2 is None and fs.shape[0] % 2:
            raise ValueError("the batch must split into two equal halves")
        fs = fs.contiguous()
        Tf = Tf.contiguous()
        f1, f2 = torch.chunk(fs, 2) if f2 is None else (fs, f2.contiguous())
        loss = self._evd_loss(fs, Tf, f1, f2)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        return (loss.detach(), dict(zip(names, grads)),
                dict(f=fs.detach(), Tf=Tf, eigvals=None), state)


class NestedLoRAForCDK:
    """NestedLoRA for the canonical dependence kernel from paired samples.

    ``model(x, y) -> (f, g)`` is a two-tower module (models/two_tower.py),
    applied to a name -> tensor parameter dict with ``functional_call``.
    The masks have L+1 entries in const mode (a constant zeroth mode).
    """

    name = "nestedlora"

    def __init__(self, model: nn.Module, neigs: int, step: int = 1,
                 sequential: bool = False, set_first_mode_const: bool = True,
                 axis_name=None, use_pallas="auto"):
        self.model = model
        self.neigs = neigs
        self.set_first_mode_const = set_first_mode_const
        self.axis_name = axis_name
        self.use_pallas = _resolve_use_pallas(use_pallas, axis_name)
        self._np_masks = _build_masks(neigs, step, sequential,
                                      set_first_mode_const)
        self._masks: Dict[torch.device, tuple] = {}

    def masks(self, device) -> tuple:
        """(vector_mask, matrix_mask) as float32 on ``device``."""
        return _device_masks(self._np_masks, self._masks, device)

    def init_state(self, params):
        return {}

    def _cdk_loss(self, fx, gy, batch_weights):
        vector_mask, matrix_mask = self.masks(fx.device)
        if _use_kernels(self.use_pallas, fx):
            return nestedlora_cdk_loss_kernels(self.set_first_mode_const, fx, gy,
                                               vector_mask, matrix_mask, batch_weights)
        return nestedlora_cdk_loss(self.set_first_mode_const, fx, gy, vector_mask,
                                   matrix_mask, batch_weights,
                                   axis_name=self.axis_name)

    def loss_and_grad(self, params, state, x, y, batch_weights=None):
        """(loss, grads {name: tensor}, aux {f, g, loss_operator,
        loss_metric}, state).  The (B, B) density-ratio gram is not
        computed here (cli/sketchy.py::make_density_ratio_fn does it once
        an epoch)."""
        fx, gy = functional_call(self.model, params, (x, y))
        loss, loss_op, loss_met, _, _ = self._cdk_loss(fx, gy, batch_weights)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        aux = dict(f=fx.detach(), g=gy.detach(), loss_operator=loss_op,
                   loss_metric=loss_met)
        return loss.detach(), dict(zip(names, grads)), aux, state
