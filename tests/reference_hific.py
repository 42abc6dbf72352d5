"""The CPU tests' plain reference of HiFiC: the benchmark's own,
portbench/reference/hific.py, with its roundings
(portbench/reference/precision.py), so that the tests and the benchmark
hold the port to one body. Neither imports anything of the port or of
JAX; the layers, paddings and roundings are described there.
"""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference.hific import (  # noqa: E402,F401
    channel_norm,
    conv,
    conv_t,
    encoder,
    generator,
    hyper_synthesis,
    serve,
    shapes,
    z_likelihood,
)
from portbench.reference.precision import BF16, FLOAT32, FP8  # noqa: E402,F401
