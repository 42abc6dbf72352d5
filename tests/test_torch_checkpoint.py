"""The PyTorch port's checkpoints against the JAX package's.

The port reads and writes flax's msgpack files with its own code
(checkpoint/flax_msgpack.py) and keeps the JAX store's ladder
(checkpoint/store.py). Here, on the CPU:

  * reader: every file the JAX GANTrainer writes at the tiny config, and
    the trained autoencoder of runs/ae_ref, read into the tree that
    flax.serialization.msgpack_restore gives (keys in order, dtypes, shapes,
    bytes); bfloat16 and chunked leaves;
  * writer: JAX file -> port tree -> port file, and JAX file -> convert ->
    state dict -> inverse -> port file, byte-identical; JAX restores
    port-written files equal;
  * store: the cases of tests/test_checkpoint.py and
    tests/test_checkpoint_durability.py on the port's store, and the same
    provenance in both packages for a directory with a corrupt final;
  * resume in both directions at the tiny config, exact, then one step from
    each restored state within test_torch_train.py's bars;
  * serving the committed JAX-trained checkpoint (tests/fixtures/jax_tiny_gan,
    made by scripts/make_jax_tiny_gan_fixture.py) against JAX's outputs;
  * nan_guard and save_mode.
"""

import json
import math
import os
import pathlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import nchw

from contextual_image_compression_tpu.checkpoint import CheckpointStore as JStore
from contextual_image_compression_tpu.config import ModelConfig as JModelConfig
from contextual_image_compression_tpu.config import QuantizerConfig as JQuantizerConfig
from contextual_image_compression_tpu.config import TrainConfig as JTrainConfig
from contextual_image_compression_tpu.data.images import synthetic_images as j_synthetic
from contextual_image_compression_tpu.data.pipeline import CompressionDataset as JDataset
from contextual_image_compression_tpu.models.adaptive import AdaptiveCodec as JCodec
from contextual_image_compression_tpu.serve import CompressionPipeline as JPipeline
from contextual_image_compression_tpu.train import gan_trainer as jgt
from contextual_image_compression_tpu.train.loop import GANTrainer as JTrainer
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
from contextual_image_compression_tpu_torch.checkpoint import flax_msgpack as fm
from contextual_image_compression_tpu_torch.config import (
    ModelConfig,
    QuantizerConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS
from contextual_image_compression_tpu_torch.serve import CompressionPipeline
from contextual_image_compression_tpu_torch.train.gan_trainer import Batch
from contextual_image_compression_tpu_torch.train.loop import GANTrainer

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_tiny_gan"
AE_REF = REPO / "runs" / "ae_ref" / "model" / "autoencoder_final.msgpack"
TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
JTINY = JModelConfig(**TINY_KW, attention_use_pallas=True,
                     quantizer=JQuantizerConfig(use_pallas=True, grad_mode="reference"))
TTINY = ModelConfig(**TINY_KW, quantizer=QuantizerConfig(grad_mode="reference"))
FILES = ALL_CODEC_COMPONENTS + ("discriminator", "optimizers")
LR = 1e-4


def _jcfg(model_dir):
    return JTrainConfig(model=JTINY, batch_size=4, use_perceptual=False,
                        model_dir=str(model_dir), results_dir=str(model_dir / "results"))


def _tcfg(model_dir):
    return TrainConfig(model=TTINY, batch_size=4, use_perceptual=False, model_dir=str(model_dir))


def _data():
    imgs = j_synthetic(8, (32, 32), seed=3)
    masks = np.random.RandomState(3).rand(8, 32, 32, 1).astype(np.float32)
    return imgs, masks


def _batch(seed=7):
    rng = np.random.RandomState(seed)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.array([[0.1], [1.0], [2.0], [1.0]], np.float32)
    return (jgt.Batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp)),
            Batch(nchw(img), nchw(mask), torch.from_numpy(bpp)))


def _jax_state_bytes(state):
    """The bytes the JAX store writes for each file of a train state."""
    host = jax.tree.map(np.asarray, {
        **state.codec_vars, "discriminator": state.disc_vars,
        "optimizers": {"g_opt": state.g_opt, "ls_opt": state.ls_opt, "rd_opt": state.rd_opt,
                       "d_opt": state.d_opt, "step": state.step}})
    return {name: flax.serialization.to_bytes(host[name]) for name in FILES}


def _port_state_bytes(state):
    trees = convert.codec_variables(state.codec)
    trees["discriminator"] = convert.discriminator_variables(state.disc, state.codec.cfg)
    trees["optimizers"] = convert.optimizer_variables(state)
    return {name: fm.dumps(trees[name]) for name in FILES}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX GANTrainer at the tiny config, one epoch of 2 steps, saved
    ('final') into its model_dir."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    trainer = JTrainer(_jcfg(d), log_fn=lambda s: None)
    trainer.init_state(resume=False)
    imgs, masks = _data()
    trainer.fit(JDataset(imgs, masks, batch_size=4, seed=42), epochs=1, steps_per_epoch=2,
                artifacts=False)
    return trainer, d


# ---------------------------------------------------------------- reader


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("name", FILES)
def test_reader_matches_flax_on_jax_trainer_files(jax_run, name):
    _, d = jax_run
    path = d / f"{name}_final.msgpack"
    want = flax.serialization.msgpack_restore(path.read_bytes())
    _assert_same_tree(fm.read(path), want)


def test_reader_reads_jax_metadata(jax_run):
    trainer, d = jax_run
    meta = CheckpointStore(str(d)).latest_metadata()
    assert meta == json.loads((d / "metadata_final.json").read_text())
    assert meta["epoch"] == 1 and meta["history"] == trainer.history


def test_reader_matches_flax_on_the_trained_autoencoder():
    want = flax.serialization.msgpack_restore(AE_REF.read_bytes())
    got = fm.read(AE_REF)
    _assert_same_tree(got, want)
    assert len(got["params"]) == 7


@pytest.mark.parametrize("chunk", [None, 64])
def test_reader_and_writer_on_bf16_and_chunked_trees(monkeypatch, chunk):
    """bfloat16 leaves read as torch.bfloat16 with the same bits; leaves
    above MAX_CHUNK_SIZE (made small in both packages) are chunked as flax
    chunks them and read back whole."""
    if chunk is not None:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.RandomState(0)
    tree = {"a": rng.rand(10, 7).astype(np.float32),
            "b": {"c": np.asarray(jnp.asarray(rng.rand(50), jnp.bfloat16)), "e": {}},
            "d": np.arange(5, dtype=np.int32), "s": np.asarray(3, np.int32)}
    raw = flax.serialization.msgpack_serialize(tree, in_place=True)
    assert (b"__msgpack_chunked_array__" in raw) == (chunk is not None)
    got = fm.loads(raw)
    want = flax.serialization.msgpack_restore(raw)
    bf = got["b"]["c"]
    assert bf.dtype == torch.bfloat16 and tuple(bf.shape) == (50,)
    assert bf.view(torch.int16).numpy().tobytes() == np.asarray(want["b"]["c"]).tobytes()
    _assert_same_tree({k: got[k] for k in ("a", "d", "s")}, {k: want[k] for k in ("a", "d", "s")})
    assert got["b"]["e"] == {}
    assert fm.dumps(got) == raw
    assert fm.dumps(tree) == raw


def test_reader_refuses_malformed_bytes(jax_run):
    _, d = jax_run
    raw = (d / "hq_encoder_final.msgpack").read_bytes()
    for bad in (b"", b"\x00garbage", raw[:-5], b"\xc1", raw + b"\x00"):
        with pytest.raises(fm.FormatError):
            fm.loads(bad)


def test_writer_packs_scalars_as_msgpack_does():
    """Every msgpack width the format can hold, against flax's own packer."""
    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128,
                     -129, -32768, -32769, -2 ** 31 - 1],
            "floats": [0.5, -1e300], "str": ["", "a" * 31, "b" * 32, "c" * 256, "é" * 70000],
            "bin": b"\x00" * 300, "none": None, "bools": [True, False], "complex": 1 - 2j,
            "np_scalar": np.float32(2.5), "zero_d": np.asarray(7, np.int32),
            "big": np.zeros((70000,), np.uint8), "bool_array": np.ones((2, 3), bool)}
    raw = flax.serialization.msgpack_serialize(tree, in_place=True)
    assert fm.dumps(tree) == raw
    back = fm.loads(raw)
    want = flax.serialization.msgpack_restore(raw)
    assert back["ints"] == want["ints"] and back["str"] == want["str"]
    assert back["complex"] == want["complex"] and back["np_scalar"] == want["np_scalar"]
    assert type(back["np_scalar"]) is type(want["np_scalar"])
    with pytest.raises(TypeError):
        fm.dumps({"t": (1, 2)})  # flax packs with strict_types: tuples are refused


# ---------------------------------------------------------------- writer


@pytest.mark.parametrize("name", FILES)
def test_writer_round_trips_are_byte_identical(jax_run, name):
    """JAX file -> port tree -> port file, and JAX file -> convert -> the
    port's modules / Adam states -> inverse -> port file."""
    trainer, d = jax_run
    raw = (d / f"{name}_final.msgpack").read_bytes()
    tree = fm.loads(raw)
    assert fm.dumps(tree) == raw
    state = GANTrainer(_tcfg(d / "unused"), device="cpu", log_fn=lambda s: None).init_state(False)
    if name in ALL_CODEC_COMPONENTS:
        mod = getattr(state.codec, name)
        mod.load_state_dict(convert.component_state(name, tree, TTINY))
        back = convert.component_variables(name, mod, TTINY)
    elif name == "discriminator":
        state.disc.load_state_dict(convert.convert_discriminator_variables(tree, TTINY))
        back = convert.discriminator_variables(state.disc, TTINY)
    else:
        convert.load_optimizer_variables(state, tree)
        # two codec steps, one of them with D
        for opt, count in ((state.g_opt, 2), (state.ls_opt, 2), (state.d_opt, 1)):
            assert {float(s["step"]) for s in opt.adam.state.values()} == {count}
        assert state.step == 2
        back = convert.optimizer_variables(state)
    out = d / "port_written" / f"{name}.msgpack"
    out.parent.mkdir(exist_ok=True)
    with open(out, "wb") as f:
        fm.write(f, back)
    assert out.read_bytes() == raw


def test_autoencoder_round_trip_is_byte_identical(tmp_path):
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    trainer = AETrainer(device="cpu", log_fn=lambda s: None)
    trainer.load(str(AE_REF.parent))
    trainer.save(str(tmp_path))
    assert (tmp_path / "autoencoder_final.msgpack").read_bytes() == AE_REF.read_bytes()


def test_jax_restores_port_written_files(tmp_path):
    """Files the port writes from its own state (after one step, Adam moments
    nonzero) restore in JAX's store, with JAX's templates, to the port's
    values exactly."""
    trainer = GANTrainer(_tcfg(tmp_path), device="cpu", log_fn=lambda s: None,
                         save_mode="host")
    state = trainer.init_state(resume=False)
    trainer.builder.train_step(state, _batch()[1], True)
    trainer.save("final")
    want = _port_state_bytes(state)
    jstate = jgt.GANStepBuilder(_jcfg(tmp_path)).init_state(jax.random.PRNGKey(0), batch_size=4)
    jstore = JStore(str(tmp_path))
    templates = {**jstate.codec_vars, "discriminator": jstate.disc_vars,
                 "optimizers": {"g_opt": jstate.g_opt, "ls_opt": jstate.ls_opt,
                                "rd_opt": jstate.rd_opt, "d_opt": jstate.d_opt,
                                "step": jstate.step}}
    for name in FILES:
        got = jstore.load_component(name, templates[name], "final")
        assert flax.serialization.to_bytes(jax.tree.map(np.asarray, got)) == want[name], name
    assert jstore.latest_metadata() == {"epoch": 0, "history": trainer.history}


# ---------------------------------------------------------------- store


def _tree(val):
    return {"w": np.full((4, 4), val, np.float32), "b": np.zeros((4,), np.float32)}


def _store_roundtrip(store, tmp):
    tree = {"params": {"dense": {"kernel": np.ones((4, 4), np.float32),
                                 "bias": np.zeros((4,), np.float32)}}}
    store.save_component("hq_encoder", tree, "final")
    loaded = store.load_component("hq_encoder", {"params": {"dense": {
        "kernel": np.zeros((4, 4), np.float32), "bias": np.zeros(4, np.float32)}}}, "final")
    np.testing.assert_array_equal(loaded["params"]["dense"]["kernel"], 1.0)


def _store_epoch_scan(store, tmp):
    for epoch in (5, 10, 15):
        store.save_component("hq_encoder", _tree(1.0), f"epoch_{epoch}")
    assert store.available_epochs("hq_encoder") == [5, 10, 15]


def _store_fallback_ladder(store, tmp):
    store.save_component("a", _tree(1.0), "final")
    store.save_component("b", _tree(2.0), "epoch_5")
    store.save_component("b", _tree(3.0), "epoch_10")
    loaded, provenance = store.load_components(
        {"a": _tree(0.0), "b": _tree(0.0), "c": _tree(-1.0)})
    assert provenance == {"a": "final", "b": "epoch_10", "c": "init"}
    for name, val in (("a", 1.0), ("b", 3.0), ("c", -1.0)):
        np.testing.assert_array_equal(loaded[name]["w"], val)


def _store_metadata(store, tmp):
    store.save_metadata({"epoch": 7, "history": {"g_loss": [1.0, 0.5]}}, "epoch_7")
    assert store.latest_metadata()["epoch"] == 7
    store.save_metadata({"epoch": 20}, "final")
    assert store.latest_metadata()["epoch"] == 20


def _store_corrupt_final(store, tmp):
    store.save_component("enc", _tree(3.0), "epoch_7")
    with open(store._path("enc", "final"), "wb"):
        pass
    loaded, provenance = store.load_components({"enc": _tree(0.0)})
    assert provenance["enc"] == "epoch_7"
    np.testing.assert_array_equal(loaded["enc"]["w"], 3.0)


def _store_corrupt_epoch(store, tmp):
    store.save_component("enc", _tree(1.0), "epoch_5")
    with open(store._path("enc", "epoch_10"), "wb") as f:
        f.write(b"\x00garbage")
    loaded, provenance = store.load_components({"enc": _tree(0.0)})
    assert provenance["enc"] == "epoch_5"
    np.testing.assert_array_equal(loaded["enc"]["w"], 1.0)


def _store_atomic(store, tmp):
    path = store.save_component("enc", _tree(2.0), "final")
    assert not path.endswith(".tmp")
    store.save_metadata({"epoch": 3}, "final")
    assert store.load_metadata("final") == {"epoch": 3}
    assert all(not f.name.endswith(".tmp") for f in tmp.iterdir())


def _store_missing_key_falls_through(store, tmp):
    """flax's from_bytes raises when the file lacks a key of the template
    and drops keys only the file has; shapes are not checked."""
    store.save_component("enc", {"w": np.ones((2,), np.float32), "extra": np.ones(1)}, "final")
    store.save_component("enc", _tree(5.0), "epoch_1")
    loaded, provenance = store.load_components({"enc": _tree(0.0)})
    assert provenance["enc"] == "epoch_1"
    loaded = store.load_component("enc", {"w": np.zeros((7,), np.float32)}, "final")
    assert list(loaded) == ["w"] and loaded["w"].shape == (2,)


def _store_makes_its_directory(store, tmp):
    sub = tmp / "a" / "b"
    CheckpointStore(str(sub))
    assert sub.is_dir()


STORE_CASES = {f.__name__[len("_store_"):]: f for f in (
    _store_roundtrip, _store_epoch_scan, _store_fallback_ladder, _store_metadata,
    _store_corrupt_final, _store_corrupt_epoch, _store_atomic, _store_missing_key_falls_through,
    _store_makes_its_directory)}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_store_cases(tmp_path, case):
    STORE_CASES[case](CheckpointStore(str(tmp_path)), tmp_path)


def test_corrupt_final_gives_the_same_provenance_in_both_packages(tmp_path):
    """A directory with a truncated final, a garbage final, a good epoch and
    a missing component: the same provenance from both stores."""
    jstore = JStore(str(tmp_path))
    jstore.save_component("a", _tree(1.0), "epoch_3")
    jstore.save_component("b", _tree(2.0), "epoch_3")
    jstore.save_component("b", _tree(2.5), "final")
    jstore.save_component("d", _tree(4.0), "final")
    with open(jstore._path("a", "final"), "wb"):
        pass
    with open(jstore._path("d", "final"), "wb") as f:
        f.write(b"\x81\xa1w\xc1")
    templates = {n: _tree(0.0) for n in "abcd"}
    jloaded, jprov = jstore.load_components(templates)
    loaded, prov = CheckpointStore(str(tmp_path)).load_components(templates)
    assert prov == jprov == {"a": "epoch_3", "b": "final", "c": "init", "d": "init"}
    for n in "abcd":
        np.testing.assert_array_equal(loaded[n]["w"], np.asarray(jloaded[n]["w"]))


# ---------------------------------------------------------------- resume


def _step_agreement(jtrainer, jstate, tstate, tbuilder):
    """One step with D from each package's state on the same batch, held to
    test_torch_train.py's bars."""
    jbatch, tbatch = _batch(21)
    j2, jm = jtrainer.step_with_d(jstate, jbatch)
    tstate, tm = tbuilder.train_step(tstate, tbatch, True)
    for k, v in jm.items():
        rel = abs(float(tm[k]) - float(v)) / max(abs(float(v)), 1e-30)
        assert rel <= 1e-5 or abs(float(tm[k]) - float(v)) <= 1e-8, (k, tm[k], v)
    want = convert.convert_codec_variables(jax.tree.map(np.asarray, j2.codec_vars), TTINY)
    sd = tstate.codec.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    err = torch.cat([(sd[k] - want[k]).abs().reshape(-1) for k in want if k not in stats])
    assert float((err <= 1e-6).float().mean()) >= 0.999 and float(err.max()) <= 2 * LR
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)


def test_port_resumes_what_jax_saved(jax_run, tmp_path):
    """The port's init_state(resume=True) on the JAX trainer's directory:
    parameters, BN statistics, Adam moments and steps, the step counter and
    the history exactly JAX's; then one step from each."""
    jtrainer, d = jax_run
    want = _jax_state_bytes(jtrainer.state)
    trainer = GANTrainer(_tcfg(d), device="cpu", log_fn=lambda s: None)
    state = trainer.init_state(resume=True)
    assert _port_state_bytes(state) == want
    assert state.step == 2 and trainer.start_epoch == 1
    assert trainer.history == jtrainer.history
    _step_agreement(jtrainer, jax.tree.map(jnp.array, jtrainer.state), state, trainer.builder)


def test_jax_resumes_what_the_port_saved(jax_run, tmp_path):
    """The port trains one epoch of 2 steps and fit saves 'final' in the
    background; JAX's init_state(resume=True) restores it exactly; then
    one step from each."""
    jtrainer, _ = jax_run
    trainer = GANTrainer(_tcfg(tmp_path), device="cpu", log_fn=lambda s: None)
    imgs, masks = _data()
    trainer.fit(CompressionDataset(imgs, masks, batch_size=4, device="cpu"), epochs=1,
                steps_per_epoch=2, artifacts=False)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{n}_final.msgpack" for n in FILES] + ["metadata_final.json"])
    jtrainer.store = JStore(str(tmp_path))
    jstate = jtrainer.init_state(resume=True)
    assert _jax_state_bytes(jstate) == _port_state_bytes(trainer.state)
    assert jtrainer.history == trainer.history and jtrainer.start_epoch == 1
    _step_agreement(jtrainer, jstate, trainer.state, trainer.builder)


def test_fit_saves_epochs_and_resumes_the_count(tmp_path):
    """checkpoint_every: epoch_N for every Nth epoch but the last, then final;
    a resumed trainer continues the epoch count and the history."""
    import dataclasses

    cfg = dataclasses.replace(_tcfg(tmp_path), checkpoint_every=1)
    imgs, masks = _data()
    ds = CompressionDataset(imgs, masks, batch_size=4, device="cpu")
    trainer = GANTrainer(cfg, device="cpu", log_fn=lambda s: None)
    trainer.fit(ds, epochs=2, steps_per_epoch=1, artifacts=False)
    store = CheckpointStore(str(tmp_path))
    assert store.available_epochs() == [1] and store.has("optimizers", "final")
    again = GANTrainer(cfg, device="cpu", log_fn=lambda s: None)
    again.fit(ds, epochs=1, steps_per_epoch=1, artifacts=False)
    assert again.state.step == 3 and len(again.history["g_loss"]) == 3
    assert again.history["g_loss"][:2] == trainer.history["g_loss"]
    assert store.load_metadata("final")["epoch"] == 3


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def fixture_outputs():
    return np.load(FIXTURE / "outputs.npz")


def test_pipeline_serves_the_jax_trained_checkpoint(fixture_outputs):
    """The committed JAX-trained tiny GAN through the port's pipeline from
    model_dir, against the JAX pipeline's committed outputs: decoded u8
    PSNR >= 40 dB, symbols within +-1 and >= 95% identical (the serving
    bars of test_torch_serve.py),
    and provenance equal to JAX's for the same directory."""
    out = fixture_outputs
    pipe = CompressionPipeline(model_dir=str(FIXTURE), model_config=ModelConfig(**TINY_KW),
                               device="cpu")
    jpipe = JPipeline(model_dir=str(FIXTURE), model_config=JModelConfig(**TINY_KW))
    assert pipe.provenance == jpipe.provenance == {c: "final" for c in ALL_CODEC_COMPONENTS}
    dec, info = pipe(out["images"], target_bpp=float(out["target_bpp"]))
    mse = float(np.mean((dec.astype(np.float64) - out["decoded"].astype(np.float64)) ** 2))
    assert 10 * math.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0
    for key in ("hq_symbols", "lq_symbols"):
        got = info[key].float().numpy()
        assert np.mean(got == out[key]) >= 0.95 and np.abs(got - out[key]).max() <= 1.0


def test_checkpoint_codec_matches_jax_in_float32():
    """The same files in float32, the codec's latents and blended output
    against JAX's codec.apply (non-trivial where the tiny checkpoint's
    serving symbols round to 0)."""
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.serve import load_codec_checkpoint

    port = AdaptiveCodec(ModelConfig(**TINY_KW))
    port.reset_parameters(0)
    assert set(load_codec_checkpoint(port, str(FIXTURE)).values()) == {"final"}
    jcodec = JCodec(JModelConfig(**TINY_KW))
    template = jcodec.init(jax.random.PRNGKey(0), batch_size=1)
    variables, _ = JStore(str(FIXTURE)).load_components(template)
    rng = np.random.RandomState(5)
    img = rng.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(4, 32, 32, 1).astype(np.float32)
    bpp = np.full((4, 1), 1.0, np.float32)
    jout, _ = jcodec.apply(variables, jnp.asarray(img), jnp.asarray(mask), jnp.asarray(bpp),
                           train=False)
    with torch.no_grad():
        tout = port.apply(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(bpp))
    for key in ("hq_latent", "lq_latent", "blended"):
        want = np.asarray(getattr(jout, key))
        got = getattr(tout, key).numpy()
        assert np.abs(want).max() > 1e-3, key
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0, err_msg=key)


def test_pipeline_provenance_without_files(tmp_path):
    pipe = CompressionPipeline(model_dir=str(tmp_path / "empty"),
                               model_config=ModelConfig(**TINY_KW), device="cpu")
    assert pipe.provenance == {c: "init" for c in ALL_CODEC_COMPONENTS}
    assert (tmp_path / "empty").is_dir()


# ---------------------------------------------------------------- guards


def test_nan_guard_raises_with_the_bad_tensor(tmp_path):
    imgs, masks = _data()
    ds = CompressionDataset(imgs, masks, batch_size=4, device="cpu")
    trainer = GANTrainer(_tcfg(tmp_path), device="cpu", log_fn=lambda s: None, nan_guard=True)
    state = trainer.init_state(resume=False)
    with torch.no_grad():
        state.codec.hq_encoder.conv1.weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError) as err:
        trainer.fit(ds, epochs=1, steps_per_epoch=1, artifacts=False)
    msg = str(err.value)
    assert "at step 1" in msg and "hq_encoder.conv1.weight" in msg
    assert not os.path.exists(tmp_path / "hq_encoder_final.msgpack")


def test_save_modes_write_the_same_bytes(tmp_path):
    """'host' and 'background' saves of the same state are byte-identical;
    an unknown mode raises."""
    with pytest.raises(ValueError):
        GANTrainer(_tcfg(tmp_path / "x"), device="cpu", save_mode="disk")
    dirs = {}
    for mode in ("background", "host"):
        dirs[mode] = tmp_path / mode
        trainer = GANTrainer(_tcfg(dirs[mode]), device="cpu", log_fn=lambda s: None,
                             save_mode=mode)
        state = trainer.init_state(resume=False)
        trainer.builder.train_step(state, _batch()[1], True)
        trainer.save("epoch_1")
        trainer._join_saver()
    names = sorted(os.listdir(dirs["host"]))
    assert names == sorted(os.listdir(dirs["background"])) and len(names) == len(FILES) + 1
    for n in names:
        assert (dirs["host"] / n).read_bytes() == (dirs["background"] / n).read_bytes(), n
