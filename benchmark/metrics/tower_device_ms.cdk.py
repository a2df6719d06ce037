"""tower_device_ms.cdk: device ms a step launched inside
``train.loss_and_grad`` and outside ``loss.*``: both towers
(``program_spans.tower_device_ms``)."""
from benchmark.program_spans import tower_device_ms as read  # noqa: F401
