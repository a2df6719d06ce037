"""setup_kernels_s: seconds of the program's ``setup.kernels`` (the kernel
library's first load) less an nvcc build inside it
(``program_spans.setup_kernels_s``)."""
from benchmark.program_spans import setup_kernels_s as read  # noqa: F401
