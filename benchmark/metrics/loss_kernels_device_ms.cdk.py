"""loss_kernels_device_ms.cdk: device ms a step launched inside
``loss.forward`` and ``loss.backward``
(``program_spans.loss_kernels_device_ms``)."""
from benchmark.program_spans import loss_kernels_device_ms as read  # noqa: F401
