"""Run one cell of the benchmark: ``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout
(``python3 -m benchmark.run`` works too).

Prints the card and its state, each block's rate, and as its last line one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``breakdown``) and ``checks``, each
number compared beside its limit (also the last lines on standard error).
Exits non-zero, printing no result, without the cards the cell asks for or
where the process holds JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# run as a script, this folder would shadow top-level modules (``trace``)
sys.path[:] = [CHECKOUT] + [p for p in sys.path
                             if os.path.abspath(p or ".") not in (HERE, CHECKOUT)]

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
