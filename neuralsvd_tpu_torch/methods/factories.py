"""Method factories.

Port of ``neuralsvd_tpu/methods/factories.py``: ``get_evd_method``
(:13-37: NestedLoRA, NeuralEF, SpIN and SpINx) and ``get_cdk_method``
(:40-46), with the data-parallel ``axis_name`` (a process group or None,
parallel/collectives.py) passed to every method, and the tp group
(``mode_axis``, None without one) to every EVD method.
"""
from __future__ import annotations

from torch import nn

from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA, NestedLoRAForCDK
from neuralsvd_tpu_torch.methods.neuralef import NeuralEigenfunctions
from neuralsvd_tpu_torch.methods.spin import SpIN
from neuralsvd_tpu_torch.methods.spinx import SpINx


def get_evd_method(method_name: str, model: nn.Module, neigs: int,
                   sort: bool = False, axis_name=None, mode_axis=None, **opts):
    """name -> method instance; options mirror the reference's namespaced
    flags (--neuralsvd.step, --neuralsvd.sequential, --use_pallas,
    --neuralef.batchnorm_mode, --neuralef.unbiased, --neuralef.include_diag,
    --spin.decay)."""
    if method_name in ("neuralsvd", "nestedlora"):
        return NestedLoRA(model, neigs, step=opts.get("step", 1),
                          sequential=opts.get("sequential", False), sort=sort,
                          axis_name=axis_name, mode_axis=mode_axis,
                          use_pallas=opts.get("use_pallas", "auto"))
    if method_name == "neuralef":
        return NeuralEigenfunctions(
            model, neigs, batchnorm_mode=opts.get("batchnorm_mode", "unbiased"),
            unbiased=opts.get("unbiased", False),
            include_diag=opts.get("include_diag", False), sort=sort,
            axis_name=axis_name, mode_axis=mode_axis)
    if method_name == "spin":
        return SpIN(model, neigs, decay=opts.get("decay", 0.01), axis_name=axis_name,
                    mode_axis=mode_axis)
    if method_name == "spinx":
        return SpINx(model, neigs, decay=opts.get("decay", 0.01), axis_name=axis_name,
                     mode_axis=mode_axis)
    raise NotImplementedError(method_name)


def get_cdk_method(method_name: str, model: nn.Module, neigs: int,
                   axis_name=None, **opts):
    if method_name in ("neuralsvd", "nestedlora"):
        return NestedLoRAForCDK(
            model, neigs, step=opts.get("step", 1),
            sequential=opts.get("sequential", False),
            set_first_mode_const=opts.get("set_first_mode_const", True),
            axis_name=axis_name,
            use_pallas=opts.get("use_pallas", "auto"))
    raise NotImplementedError(method_name)
