"""update_kernels_per_step.pde: kernels a step launched inside ``train.clip``,
``train.optimizer`` and ``train.ema``
(``program_spans.update_kernels_per_step``)."""
from benchmark.program_spans import update_kernels_per_step as read  # noqa: F401
