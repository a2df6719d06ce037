"""optimizer_device_ms.cdk: device ms a step launched inside ``train.clip`` and
``train.optimizer`` (``program_spans.optimizer_device_ms``)."""
from benchmark.program_spans import optimizer_device_ms as read  # noqa: F401
