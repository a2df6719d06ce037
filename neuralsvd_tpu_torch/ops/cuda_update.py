"""The train step's fused update on the card: two hand-written CUDA passes.

``grad_status`` (one launch, ``csrc/update_kernels.cu::grad_norm_kernel``)
reads every gradient tensor once for ‖g‖² and a count of non-finite
entries, and writes ‖g‖, the clip scale and the skip flag.
``apply_update`` (one launch, ``apply_kernel``) reads each element of the
gradients, the parameters, the optimizer's moments and the EMA once and
writes the new ones: clip, RMSprop or the optax trace, -lr·u, p + u, all
kept on a skipped step, then the EMA.  A list of more than
``MAX_TENSORS`` tensors takes one launch per ``MAX_TENSORS``.  They replace
no Pallas kernel (the JAX package leaves the update to XLA); the plain
route (``training/optimizers.py`` and the two train steps) is their CPU
twin and their test oracle, and ``training.optimizers.fused_rule`` says
when a step takes them.  Bound: bytes (csrc/update_kernels.cu).

The wrappers take CUDA tensors only (float32, on one device) and raise on
anything else; the kernels update the parameters, the moments and the EMA
in place.  Each wrapper counts its launches in the process counter
``update_kernels.<wrapper>`` (``launch_counts``), none under CUDA-graph
capture, as ``ops/cuda_gram.py`` counts K1-K3.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from neuralsvd_tpu_torch.ops.cuda_gram import _launch, _stream, _ticket
from neuralsvd_tpu_torch.utils import tracing

CHUNK = 4096  # elements a block (csrc kChunk)
MAX_TENSORS = 32  # tensors a launch (csrc kMaxTensors)
RULES = {"rmsprop": 0, "trace": 1}  # csrc kRmsprop, kTrace
COUNTER_PREFIX = "update_kernels."


class GradStatus(NamedTuple):
    """What ``grad_status`` wrote on the device: 0-dim tensors."""
    gnorm: torch.Tensor  # ‖g‖, float32
    scale: torch.Tensor  # the clip scale, float32 (1 without a clip)
    skipped: torch.Tensor  # bool: the step is not taken


def _blocks(sizes: Sequence[int]) -> int:
    return sum(-(-n // CHUNK) for n in sizes)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _sizes(tensors) -> ctypes.Array:
    return (ctypes.c_longlong * len(tensors))(*(t.numel() for t in tensors))


def _checked(tensors, name: str, device=None) -> list:
    """``tensors`` as a list; raises unless each is float32 and contiguous
    on ``device`` (the first's where None)."""
    tensors = list(tensors)
    device = tensors[0].device if device is None and tensors else device
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 tensors on {device}, "
                             f"got {t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
    return tensors


def _card_stream(tensors, name: str) -> int:
    """The current stream of the device of ``tensors``, a non-empty list
    on one CUDA device; raises on anything else."""
    if not tensors or tensors[0].device.type != "cuda":
        raise ValueError(f"{name} takes a non-empty list of CUDA tensors")
    return _stream(tensors[0])


def _count(wrapper, n_tensors: int) -> None:
    if not torch.cuda.is_current_stream_capturing():
        tracing.count(COUNTER_PREFIX + wrapper.__name__, -(-n_tensors // MAX_TENSORS))


def grad_status(grads, loss: Optional[torch.Tensor] = None, clip: float = 0.0,
                clip_eps: float = 0.0, by_entries: bool = False) -> GradStatus:
    """‖g‖ over the gradient tensors ``grads``, the clip scale
    min(1, clip / (‖g‖ + clip_eps)) where ``clip`` > 0 (else 1), and
    whether the step is skipped: where any entry is not finite with
    ``by_entries`` (the CDK step's rule), else where ‖g‖ or ``loss`` (a
    float32 scalar on the same device, or None) is not (E4's)."""
    grads = [g for g in _checked(grads, "grads") if g.numel()]
    stream = _card_stream(grads, "grad_status")
    if loss is not None:
        _checked([loss], "loss", grads[0].device)
    opts = dict(device=grads[0].device, dtype=torch.float32)
    partial = torch.empty((2 * _blocks([g.numel() for g in grads]),), **opts)
    out = torch.empty((2,), **opts)
    status = GradStatus(out[0], out[1], torch.empty((), dtype=torch.bool, device=out.device))
    _launch("update_grad_norm", _pointers(grads), _sizes(grads), len(grads), partial.data_ptr(),
            partial.numel(), _ticket(grads[0].device, stream).data_ptr(),
            None if loss is None else loss.data_ptr(), float(clip), float(clip_eps),
            int(by_entries), out.data_ptr(), status.skipped.data_ptr(), stream)
    _count(grad_status, len(grads))
    return status


def apply_update(status: GradStatus, grads, params, moments, emas=None, *, rule: str,
                 decay: float, eps: float = 0.0, lr, count=None, step=None,
                 ema_decay: float = 0.0) -> None:
    """The update of ``params`` and ``moments`` (and ``emas``) in place,
    lists of tensors in the same order and shapes as ``grads``: each
    gradient times ``status.scale``, then ``rule`` "rmsprop"
    (ν ← decay·ν + (1-decay)·g², u = g/(√ν + eps)) or "trace"
    (m ← g + decay·m, u = m), p ← p - lr·u; none of it where
    ``status.skipped``.  ``lr``: a float or a float32 scalar tensor (the
    schedule's value).  ``count`` (int32 scalar, or None) goes up by one
    unless the step is skipped.  With ``emas``, ema ← d·ema + (1-d)·p with
    d = min(ema_decay, (1+t)/(10+t)), t the int64 scalar ``step``, on a
    skipped step too."""
    params = _checked(params, "params")
    stream = _card_stream(params, "apply_update")
    device = params[0].device
    grads = _checked(grads, "grads", device)
    moments = _checked(moments, "moments", device)
    emas = None if emas is None else _checked(emas, "emas", device)
    for other in (grads, moments) + (() if emas is None else (emas,)):
        if [t.shape for t in other] != [p.shape for p in params]:
            raise ValueError("grads, params, moments and emas must match in shape")
    if isinstance(lr, torch.Tensor):
        _checked([lr], "lr", device)
    for t, dtype in ((count, torch.int32), (step, torch.int64)):
        if t is not None and (t.device != device or t.dtype != dtype or t.numel() != 1):
            raise ValueError(f"count and step: {dtype} scalars on {device}")
    keep = [i for i, p in enumerate(params) if p.numel()]
    grads, params, moments = ([ts[i] for i in keep] for ts in (grads, params, moments))
    emas = None if emas is None else [emas[i] for i in keep]
    lr_ptr = lr.data_ptr() if isinstance(lr, torch.Tensor) else None
    _launch("update_apply", _pointers(grads), _pointers(params), _pointers(moments),
            None if emas is None else _pointers(emas), _sizes(params), len(params),
            RULES[rule], float(decay), float(1 - decay),
            float(eps), 0.0 if lr_ptr is not None else float(lr), lr_ptr, float(ema_decay),
            None if step is None else step.data_ptr(),
            None if count is None else count.data_ptr(), status.scale.data_ptr(),
            status.skipped.data_ptr(), stream)
    _count(apply_update, len(params))


KERNELS = (grad_status, apply_update)


def launch_counts() -> dict:
    """{wrapper name: launches in this process}."""
    counts = tracing.counts()
    return {fn.__name__: counts.get(COUNTER_PREFIX + fn.__name__, 0) for fn in KERNELS}

