"""replay_attributed_share.pde: share of a whole graph replay's kernels that
line up with an eager step's kernels launched in the program's spans
(``program_spans.replay_attributed_share``)."""
from benchmark.program_spans import replay_attributed_share as read  # noqa: F401
