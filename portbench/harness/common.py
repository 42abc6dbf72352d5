"""What every cell shares: finding a cell's files by name, the card checks,
the modules that may not be loaded, and the result line.

A cell is `workloads/<cell>.json` ({"config", "traffic", "chips", "why",
"limits"}); it names `configs/<config>.json` and `traffic/<traffic>.json`,
whose "driver" names the module of `harness/` that runs it. Per-layer
metrics are `metrics/<metric>.py`; work counts are `work/<config>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
PROGRAM = "contextual_image_compression_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "contextual_image_compression_tpu")


class RunError(RuntimeError):
    """A run that cannot produce a result (no card, a missing program)."""


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def list_names(kind: str, suffix: str, bench_dir: Path = BENCH_DIR) -> List[str]:
    """The names of the files of one kind (`configs`, `traffic`,
    `workloads`, `metrics`, `work`), without their suffix."""
    return sorted(p.name[:-len(suffix)] for p in (bench_dir / kind).glob("*" + suffix))


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell with its configuration and traffic resolved."""
    cell = _json(bench_dir / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_spec"] = _json(bench_dir / "configs" / f"{cell['config']}.json")
    cell["traffic_spec"] = _json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return cell


def load_module(path: Path, name: str):
    """Import a file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work_module(config: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "work" / f"{config}.py", f"portbench_work_{config}")


def metric_modules(bench_dir: Path = BENCH_DIR) -> Dict[str, object]:
    mods = {}
    for name in list_names("metrics", ".py", bench_dir):
        mod = load_module(bench_dir / "metrics" / f"{name}.py",
                          "portbench_metric_" + name.replace(".", "_"))
        if mod.META["name"] != name:
            raise ValueError(f"metrics/{name}.py declares {mod.META['name']!r}")
        mods[name] = mod
    return mods


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    CUDA library under its own build/ directory)."""
    cache = ROOT / PROGRAM / "build"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    if not (ROOT / PROGRAM / "__init__.py").exists():
        raise RunError(f"the program {PROGRAM}/ is not in the checkout")


def card_line() -> str:
    """'name, power limit' of the first card, as nvidia-smi prints them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
