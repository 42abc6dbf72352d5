"""The port's spans (utils/profiling.py) on the CPU, at tiny widths and
with no JAX: `annotate` enters nothing with the profiler off; a serving
call and a GAN step put their spans into the trace in order, nested where
they nest, and give the same results as untraced; every span the package
opens is in `SPANS` and none takes the name of a range the benchmark opens
itself."""

import ast
import contextlib
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.models.vgg import VGG19Features
from contextual_image_compression_tpu_torch.serve import CompressionPipeline
from contextual_image_compression_tpu_torch.train.gan_trainer import GANStepBuilder
from contextual_image_compression_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ModelConfig(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
                   generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32)
PIPELINE_SPANS = ["pipeline.upload", "pipeline.mask", "pipeline.codec", "pipeline.symbols",
                  "pipeline.download"]
CODEC_SPANS = ["codec.encode", "codec.plan", "codec.quantize", "codec.generate"]


def _images(b):
    return np.random.RandomState(b).randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)


def _spans(log_dir):
    """The program's spans in the one trace under log_dir: (name, start,
    end) in order of start."""
    (name,) = os.listdir(log_dir)
    events = json.loads((log_dir / name).read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in profiling.SPANS]
    return sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def pipe():
    return CompressionPipeline(model_config=TINY, device="cpu", seed=1)


def test_annotate_off_enters_nothing(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def record(name):
        entered.append(name)
        yield

    monkeypatch.setattr(torch.profiler, "record_function", record)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: entered.append(("nvtx", name)))
    with profiling.annotate("pipeline.mask"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("pipeline.mask"):
            pass
    assert entered == ["pipeline.mask"]


def test_annotate_off_is_one_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.annotate("pipeline.mask") is profiling.annotate("codec.plan")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.annotate("pipeline.mask")
        assert isinstance(on, torch.profiler.record_function)
    assert profiling.annotate("pipeline.mask") is not on


def test_pipeline_call_spans_in_order(pipe, tmp_path):
    u8 = _images(2)
    pipe(u8)
    with profiling.trace(str(tmp_path)):
        pipe(u8)
    spans = _spans(tmp_path)
    top = [s for s in spans if s[0].startswith("pipeline.")]
    assert [s[0] for s in top] == PIPELINE_SPANS
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))  # one after another
    codec = [s for s in spans if s[0] in CODEC_SPANS]
    assert [s[0] for s in codec] == CODEC_SPANS
    assert all(_inside(s, top[2]) for s in codec)
    (attention,) = [s for s in spans if s[0] == "codec.attention"]
    assert _inside(attention, codec[0])  # the HQ encoder's


def test_ragged_call_traced_as_untraced(pipe, tmp_path):
    u8 = _images(3)  # padded to the bucket of 4, sliced back in pipeline.download
    decoded, info = pipe(u8)
    with profiling.trace(str(tmp_path)):
        traced, traced_info = pipe(u8)
    assert decoded.shape == traced.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(traced, decoded)
    for k, v in info.items():
        assert traced_info[k].shape[0] == 3
        torch.testing.assert_close(traced_info[k], v, rtol=0, atol=0)
    assert [s[0] for s in _spans(tmp_path) if s[0].startswith("pipeline.")] == PIPELINE_SPANS


@pytest.mark.parametrize("perceptual", [True, False])
def test_gan_step_spans(perceptual, tmp_path):
    vgg = VGG19Features().requires_grad_(False) if perceptual else None
    builder = GANStepBuilder(TrainConfig(model=TINY, batch_size=2, use_perceptual=perceptual),
                             vgg=vgg, device="cpu")
    state = builder.init_state(0)
    rng = np.random.RandomState(0)
    ds = CompressionDataset(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
                            rng.uniform(0, 1, (4, 32, 32, 1)).astype(np.float32),
                            batch_size=2, device="cpu")
    with profiling.trace(str(tmp_path)):
        for i, batch in enumerate(ds.epoch()):
            builder.train_step(state, batch, do_d_step=i == 0)
    spans = [s for s in _spans(tmp_path) if not s[0].startswith("codec.")]
    step = ["data.batch", "step.losses"] + ["step.perceptual"] * perceptual + ["step.backward"]
    assert [s[0] for s in spans] == step + step
    assert len([s for s in _spans(tmp_path) if s[0] == "codec.encode"]) == 2  # one forward each
    losses = [s for s in spans if s[0] == "step.losses"]
    perc = [s for s in spans if s[0] == "step.perceptual"]
    assert all(_inside(p, lo) for p, lo in zip(perc, losses))
    top = [s for s in spans if s[0] != "step.perceptual"]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))  # data.batch closes before the step


def _literals(tree, func, argpos):
    """String literals passed as argument `argpos` to calls of `func` (a
    bare name or an attribute)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and len(node.args) > argpos:
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
            arg = node.args[argpos]
            if name == func and isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def test_every_span_is_registered_and_none_is_a_benchmark_range():
    opened = []
    for path in sorted((REPO / "contextual_image_compression_tpu_torch").rglob("*.py")):
        opened += _literals(ast.parse(path.read_text()), "annotate", 0)
    assert set(opened) == set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    bench = set()
    for path in sorted((REPO / "portbench").rglob("*.py")):
        tree = ast.parse(path.read_text())
        bench.update(_literals(tree, "record_function", 0))
        bench.update(_literals(tree, "method", 2))
        bench.update(_literals(tree, "module", 1))
        bench.update(_literals(tree, "add", 0))
    assert {"serve.call", "codec.apply", "train.g_backward", "hq_attention"} <= bench
    assert not bench.intersection(profiling.SPANS)
    assert not [s for s in profiling.SPANS if s.startswith(("train.", "serve.", "portbench."))]
