"""Tests of the benchmark, on the CPU at tiny sizes. Card tests carry the
`cuda` marker and skip without a card; they never import JAX."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import common  # noqa: E402

# the sizes of tests/test_models.py (SMALL): 64x64, D = 32, generator from 4x4
TINY_MODEL = {"img_size": [64, 64], "base_latent_dim": 32, "generator_base_hw": 4}
TINY_TRAFFIC = {
    "serve": {"batch": 2, "pool": 6, "warmup_calls": 1, "check_calls": 2, "trace_calls": 2},
    "train": {"corpus": 8, "setup_steps": 3, "trace_steps": 2},
}


def tiny_cell(name: str, batch: int = 4) -> dict:
    """The cell `name` at the tiny sizes."""
    cell = copy.deepcopy(common.load_cell(name))
    cell["config_spec"]["model"].update(TINY_MODEL)
    cell["config_spec"]["saliency"]["spectral_resolution"] = 16
    traffic = cell["traffic_spec"]
    traffic.update(TINY_TRAFFIC[traffic["driver"]])
    if "train" in cell["config_spec"]:
        cell["config_spec"]["train"]["batch_size"] = batch
    return cell


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
