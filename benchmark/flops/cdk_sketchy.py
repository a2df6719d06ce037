"""The work of one Sketchy CDK training step, from the configuration's shapes.

Model FLOPs (``step_flops``).  Two towers, x and y, each
``d0 -> d1 -> ... -> L`` (512 -> 8192 -> 512), on B rows each.  The
algorithm needs, a tower and a row: the forward (Σ_i d_i·d_{i+1}
multiply-adds), the weight gradients (the same again) and the input
gradients of every layer but the first (the features take none):
``3·Σ_i d_i·d_{i+1} - d0·d1``.  The loss's grams on the (B, L+1) outputs
with the constant column: Λf and Λg as SYRKs (B·(L+1)(L+2)/2 each) and the
two metric gradients (B·(L+1)² each).

At the paper's width (B 4096, L 512): towers 2·2·4096·(3·8,388,608 -
4,194,304) = 343.6 GFLOP, grams 2·4096·(513·514 + 2·513²) = 6.47 GFLOP;
350.1 GFLOP a step.  Element-wise work (activations, the row norms, the
operator term) is left out: under 0.1%.

The gram work (``gram_work``): K1 and K3 on (f, g), each (B, L+1), and K2
on the same pair: see ``flops/gram.py``.
"""
from __future__ import annotations

from benchmark.flops import gram

INPUT_DIM = 512  # VGG16's feature width, the towers' input


def _dims(flags: dict) -> list:
    return [INPUT_DIM] + [int(h) for h in str(flags["network_dims"]).split(",")]


def step_flops(flags: dict) -> float:
    """Model float operations of one training step (module docstring)."""
    B, L1 = int(flags["batch_size"]), int(flags["neigs"]) + 1
    dims = _dims(flags)
    tower = 3 * sum(a * b for a, b in zip(dims[:-1], dims[1:])) - dims[0] * dims[1]
    grams = L1 * (L1 + 1) + 2 * L1 * L1
    return 2.0 * B * (2 * tower + grams)


def gram_work(flags: dict) -> list:
    """[(bytes, operations)] of K1, K2, K3 in one step."""
    B, L1 = int(flags["batch_size"]), int(flags["neigs"]) + 1
    return [gram.masked_gram_pair(B, L1), gram.weighted_dot(B, L1),
            gram.metric_grads(B, L1)]
