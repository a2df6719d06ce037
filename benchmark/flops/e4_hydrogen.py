"""The work of one E4 training step, from the configuration's shapes.

Model FLOPs (``step_flops``).  A row x passes through L towers, each
``d0 -> h1 -> ... -> 1`` with d0 = 2m + 1 + n_env features (m Fourier maps,
the radius, n_env envelopes): ``macs_row = L·Σ_i d_i·d_{i+1}``.  The
algorithm needs, for each row of the batch B:

- the forward Laplacian: every layer's product carries the value, the D
  coordinate directions and the Laplacian: (D + 2)·macs_row;
- the backward of the value channel: the weight gradient of every layer
  (macs_row) and the input gradient of every layer but the first (the
  features take no gradient): macs_row - L·d0·d1.

That is ``B·((D + 4)·macs_row - L·d0·d1)`` multiply-adds, two operations
each.  The element-wise work (activations, features, the potential) and the
loss's grams (B·L² at L = 16) are left out: under 1% of it.  At E4 (L 16,
D 2, m 1024, 4 envelopes, 128³, B 512): macs_row = 4,730,880, the step
2·512·(6·4,730,880 - 16·2053·128) = 24.76 GFLOP.  A program that takes
the Laplacian another way (nested JVPs, finite differences) is divided by
the same count.

The gram work (``gram_work``): the loss's K1 and K3 on the halves (B/2, L)
and K2 on (fs, Tf), (B, L): see ``flops/gram.py``.
"""
from __future__ import annotations

from benchmark.flops import gram


def _dims(flags: dict) -> list:
    m = int(flags["fourier_mapping_size"])
    n_env = len([v for v in str(flags.get("fourier_append_envelopes", "")).split(",") if v])
    return ([2 * m + int(bool(flags.get("fourier_append_radial"))) + n_env]
            + [int(h) for h in str(flags["mlp_hidden_dims"]).split(",")] + [1])


def step_flops(flags: dict) -> float:
    """Model float operations of one training step (module docstring)."""
    L, B, D = int(flags["neigs"]), int(flags["batch_size"]), int(flags["ndim"])
    dims = _dims(flags)
    macs_row = L * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2.0 * B * ((D + 4) * macs_row - L * dims[0] * dims[1])


def gram_work(flags: dict) -> list:
    """[(bytes, operations)] of K1, K2, K3 in one step."""
    L, B = int(flags["neigs"]), int(flags["batch_size"])
    return [gram.masked_gram_pair(B // 2, L), gram.weighted_dot(B, L),
            gram.metric_grads(B // 2, L)]
