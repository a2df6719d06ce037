"""sample_device_ms.pde: device ms a step launched inside the program's
``train.sample`` span (``program_spans.sample_device_ms``)."""
from benchmark.program_spans import sample_device_ms as read  # noqa: F401
