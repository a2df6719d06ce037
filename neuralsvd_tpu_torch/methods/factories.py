"""Method factories.

Port of ``neuralsvd_tpu/methods/factories.py``: the NestedLoRA branch of
``get_evd_method`` (:13) and ``get_cdk_method`` (:40).  The other EVD
methods (NeuralEF, SpIN, SpINx) are not ported yet (ROADMAP queue 1,
item 8); the data-parallel ``axis_name`` waits for item 9.
"""
from __future__ import annotations

from torch import nn

from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA, NestedLoRAForCDK


def get_evd_method(method_name: str, model: nn.Module, neigs: int,
                   sort: bool = False, **opts):
    """name -> method instance; options mirror the reference's namespaced
    flags (--neuralsvd.step, --neuralsvd.sequential, --use_pallas)."""
    if method_name in ("neuralsvd", "nestedlora"):
        return NestedLoRA(model, neigs, step=opts.get("step", 1),
                          sequential=opts.get("sequential", False), sort=sort,
                          use_pallas=opts.get("use_pallas", "auto"))
    raise NotImplementedError(
        f"{method_name} is not ported yet (ROADMAP queue 1, item 8)")


def get_cdk_method(method_name: str, model: nn.Module, neigs: int, **opts):
    if method_name in ("neuralsvd", "nestedlora"):
        return NestedLoRAForCDK(
            model, neigs, step=opts.get("step", 1),
            sequential=opts.get("sequential", False),
            set_first_mode_const=opts.get("set_first_mode_const", True),
            use_pallas=opts.get("use_pallas", "auto"))
    raise NotImplementedError(method_name)
