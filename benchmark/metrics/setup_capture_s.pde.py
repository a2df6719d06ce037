"""setup_capture_s.pde: seconds of the program's ``setup.capture`` less
``setup.kernels`` inside it (``program_spans.setup_capture_s``)."""
from benchmark.program_spans import setup_capture_s as read  # noqa: F401
