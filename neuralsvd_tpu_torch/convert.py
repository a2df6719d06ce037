"""Carry JAX wavefunction parameters into the port's modules.

``params_from_jax`` maps the JAX package's ParallelMLP wavefunction tree
``{"base": {"ws": [(L, h, d), ...], "bs": [(L, h, 1), ...],
"feature_map": {}}}`` (leaves already converted to numpy) onto the state
dict of ``models.wavefunctions.Wavefunction``, so that both packages
compute the same function in the tests.  It imports nothing of JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """-> {"base.ws.0": tensor, ..., "base.bs.0": tensor, ...} (float32)."""
    base = tree["base"]
    if base.get("feature_map"):
        raise ValueError("feature maps carry no parameters in either package")
    if "mask" in tree:
        raise NotImplementedError(
            "exp-mask parameters are not ported yet (ROADMAP queue 1, item 3)")
    out = {}
    for group in ("ws", "bs"):
        for i, leaf in enumerate(base.get(group, [])):
            out[f"base.{group}.{i}"] = torch.tensor(
                np.asarray(leaf, dtype=np.float32))
    return out

