"""The plain reference against the port, at the tiny sizes of
tests/test_models.py, on the CPU; the controls and the planted faults, which
the check must call incorrect."""

import time

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from portbench.harness import check, faults, inputs, runner, serve, train
from portbench.reference import codec as ref_codec
from portbench.reference import masks as ref_masks
from portbench.reference import precision
from portbench.reference import train as ref_train

SEED = 2 ** 33 + 17  # larger than 32 signed bits, as the driver's seeds are


def _run(cell, **kw):
    torch.manual_seed(0)
    return runner.execute(cell, SEED, 0.2, False, "cpu", time.perf_counter(), **kw)


def test_shape_tables_are_the_ports():
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.models.discriminator import Discriminator
    from contextual_image_compression_tpu_torch.models.vgg import VGG19Features

    spec = tiny_cell("train_b16")["config_spec"]
    mcfg, _ = serve.model_config(spec)
    m = spec["model"]

    def shapes(module):
        return {k: tuple(v.shape) for k, v in module.state_dict().items()}

    assert shapes(AdaptiveCodec(mcfg)) == ref_codec.codec_shapes(m)
    disc = Discriminator(mcfg.img_size, mcfg.channels, mcfg.disc_base_filters,
                         mcfg.disc_max_filters, mcfg.disc_max_stages, mcfg.disc_dense_units)
    assert shapes(disc) == ref_train.disc_shapes(m)
    assert shapes(VGG19Features()) == ref_train.vgg_shapes()


def test_mask_matches_the_ports_engine():
    from contextual_image_compression_tpu_torch.ops.masks import compute_contextual_mask

    cell = tiny_cell("serve_b16")
    _, scfg = serve.model_config(cell["config_spec"])
    images = inputs.structured_images(SEED, 4, 64, "cpu")
    want = ref_masks.contextual_mask(images, cell["config_spec"]["saliency"])
    got = compute_contextual_mask(images, scfg)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["serve_b16", "serve_b128"])
def test_serving_cell_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["check"]
    assert res["check"]["mask_gap"]["value"] < 1e-4


@pytest.mark.parametrize("name", ["train_b16", "train_b16_noperc"])
def test_training_cell_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["check"]


def test_serving_control_is_incorrect():
    """The reference in float8 (its mask engine in bfloat16) put in the
    program's place fails the serving cell's limits."""
    cell = tiny_cell("serve_b16")
    spec, m = cell["config_spec"], cell["config_spec"]["model"]
    params, tails = ref_codec.serving_params(
        inputs.make_weights(ref_codec.codec_shapes(m), SEED, "codec", "cpu"), m)
    images = inputs.structured_images(SEED, 4, 64, "cpu")
    want = check.serving_reference(params, tails, spec, images, 1.0)
    got = check.serving_reference(params, tails, spec, images, 1.0, precision.FP8,
                                  precision.BF16)
    gaps = check.serving_gaps([got], [want])
    assert not check.verdict(gaps, cell["limits"]), gaps
    assert gaps["mask_gap"] > cell["limits"]["mask_gap"]


def test_training_control_is_incorrect():
    """The reference with TF32 operands put in the program's place fails the
    training cell's limits."""
    cell = tiny_cell("train_b16_noperc")
    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    want = train.reference_steps(spec, traffic, SEED, "cpu")
    got = train.reference_steps(spec, traffic, SEED, "cpu", precision.TF32)
    gaps = check.training_gaps(got, want)
    assert not check.verdict(gaps, cell["limits"]), gaps


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_incorrect(fault):
    res = _run(tiny_cell("serve_b16"), fault=faults.SERVE[fault])
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_incorrect(fault):
    res = _run(tiny_cell("train_b16_noperc"), fault=faults.TRAIN[fault])
    assert not res["correct"], res["check"]


def test_reference_batches_follow_the_dataset():
    """The reference's batch order and bpps are the port's dataset's."""
    from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset

    cell = tiny_cell("train_b16")
    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    images = inputs.structured_images(SEED, traffic["corpus"], 64, "cpu")
    floats = (images.float() / 127.5 - 1.0).numpy()
    ds = CompressionDataset(floats, np.zeros(floats.shape[:3] + (1,), np.float32),
                            batch_size=spec["train"]["batch_size"],
                            bpp_range=tuple(spec["train"]["bpp_range"]),
                            seed=train.dataset_seed(SEED), device_resident=True, device="cpu")
    sched = train.Schedule(ds, spec["train"]["d_every_n_steps"])
    for img, _, bpp, do_d in train.reference_batches(spec, traffic, SEED, "cpu", steps=5):
        batch, d = sched.next()
        assert d == do_d
        assert torch.equal(batch.image, img)
        assert torch.equal(batch.bpp, bpp)


@pytest.mark.cuda
def test_serving_cell_on_the_card(card):
    """One short run of serve_b16 at the cell's own size on the card."""
    from portbench.harness import common

    res = runner.execute(common.load_cell("serve_b16"), SEED, 1.0, False, card,
                         time.perf_counter())
    assert res["correct"], res["check"]
