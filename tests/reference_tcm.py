"""The CPU tests' plain reference of TCM: the benchmark's own,
portbench/reference/tcm.py, with its roundings
(portbench/reference/precision.py), so that the tests and the benchmark
hold the port to one body. Neither imports anything of the port or of
JAX; the layers, the windows and masks and the roundings are described
there.
"""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference.tcm import (  # noqa: E402,F401
    gdn,
    serve,
    shapes,
    slice_chain,
    wmsa,
)
from portbench.reference.precision import BF16, FLOAT32, FP8  # noqa: E402,F401
