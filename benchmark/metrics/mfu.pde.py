"""mfu.pde: the PDE training step's model FLOPs a second over the float32 peak
(moves train_samples_per_s) (``readers.mfu``)."""
from benchmark.readers import mfu as read  # noqa: F401
