"""SpectralNormDense, the public helpers and the last single-device CLIs of the
PyTorch port against the JAX package.

  * `models.SpectralNormDense` against flax's layer: calls with and without
    `update_stats`, outputs and `u`, gradients, and convert.py both ways;
  * `ops/image_ops.py`'s range maps and `resize_bilinear` (down and up),
    `utils/tree.py`'s `tree_finite` and `cast_floats`, and `__version__`;
  * scripts/torch_compare_rd.py and torch_convert_vgg_weights.py against
    scripts/compare_rd.py and convert_vgg_weights.py (each script's main
    run in this process: the port's as main(argv, device="cpu"), the JAX
    script with its argv); torch_profile_codec.py and
    torch_layer_microbench.py through main(argv, device="cpu") with the
    port's ModelConfig defaults patched to the tiny widths of
    tests/test_torch_clis.py, printing the JSON keys of the JAX scripts
    (read from their sources: they time the full-width codec).

No weights are downloaded: the VGG19 files are synthetic state dicts of
VGG19's shapes written to a temporary directory.
"""

import csv
import functools
import hashlib
import json
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu import __version__ as jversion
from contextual_image_compression_tpu.models import vgg as jvgg
from contextual_image_compression_tpu.models.spectral_norm import SpectralNormDense as JSND
from contextual_image_compression_tpu.ops import image_ops as jiops
from contextual_image_compression_tpu.utils import tree as jtree
from contextual_image_compression_tpu_torch import __version__ as tversion
from contextual_image_compression_tpu_torch import config as tconfig
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.models import SpectralNormDense
from contextual_image_compression_tpu_torch.models import vgg as tvgg
from contextual_image_compression_tpu_torch.ops import image_ops as tiops
from contextual_image_compression_tpu_torch.utils import tree as ttree

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
TINY_KW = dict(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
               generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32)


# ------------------------------------------------------- SpectralNormDense


def test_spectral_norm_dense_matches_flax():
    """Three calls with update_stats=True, then one with False: outputs and
    u within 1e-6 after each (measured 2.4e-7 and 6.0e-8); u's start
    1 / sqrt(out) bit for bit; the gradients of x, the kernel and the bias
    of the last call within 1e-6 of their largest magnitude (measured
    8.3e-8); the variables carried both ways by convert.py."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 12).astype(np.float32)
    mod = JSND(7)
    v = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["kernel"] = v["params"]["kernel"] * 3 + rng.randn(12, 7).astype(np.float32)
    v["params"]["bias"] = rng.randn(7).astype(np.float32)
    port = SpectralNormDense(12, 7)
    np.testing.assert_array_equal(port.u.numpy(), v["spectral_stats"]["u"])
    port.load_state_dict(convert.convert_layer_variables(v))
    for update in (True, True, True, False):
        y, mut = mod.apply(v, jnp.asarray(x), update_stats=update, mutable=["spectral_stats"])
        v = {"params": v["params"], "spectral_stats": jax.tree.map(np.asarray,
                                                                   mut["spectral_stats"])}
        got = port(torch.from_numpy(x), update_stats=update)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-6)
        np.testing.assert_allclose(port.u.numpy(), v["spectral_stats"]["u"], atol=1e-6)
    g = rng.randn(4, 7).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: mod.apply({"params": p, "spectral_stats": v["spectral_stats"]},
                                             xx, update_stats=False), v["params"], jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(g))
    port.zero_grad()
    xt = torch.from_numpy(x).requires_grad_(True)
    port(xt, update_stats=False).backward(torch.from_numpy(g))
    for got, want in ((xt.grad.numpy(), jx), (port.weight.grad.numpy().T, jp["kernel"]),
                      (port.bias.grad.numpy(), jp["bias"])):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    back = convert.layer_variables(port)
    assert sorted(back) == ["params", "spectral_stats"]
    np.testing.assert_array_equal(back["params"]["kernel"], v["params"]["kernel"])
    np.testing.assert_array_equal(back["params"]["bias"], v["params"]["bias"])
    np.testing.assert_array_equal(back["spectral_stats"]["u"], port.u.numpy())


def test_spectral_norm_dense_init_and_export():
    """reset_parameters: glorot-uniform weight, zero bias, u back to
    1 / sqrt(out); the module is exported from models, as in JAX."""
    from contextual_image_compression_tpu_torch import models

    assert "SpectralNormDense" in models.__all__
    layer = SpectralNormDense(20, 5)
    layer(torch.ones(2, 20))
    layer.reset_parameters(torch.Generator().manual_seed(0))
    limit = float(np.sqrt(6.0 / 25))
    assert float(layer.weight.detach().abs().max()) <= limit and not torch.any(layer.bias)
    u0 = np.float32(1) / np.sqrt(np.float32(5))
    np.testing.assert_array_equal(layer.u.numpy(), np.full((1, 5), u0))


# ------------------------------------------------------------ the helpers


def test_range_maps_match_jax():
    """to_gan_range, from_gan_range (round half to even, clipped),
    to_unit_range and from_unit_range bit for bit, uint8 and float."""
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    f = np.concatenate([np.linspace(-1.2, 1.2, 101), (np.arange(-2, 258) + 0.5) / 127.5 - 1,
                        np.arange(-2, 258) / 255.0 + 0.5 / 255]).astype(np.float32)
    for name, arg in (("to_gan_range", u8), ("to_unit_range", u8), ("from_gan_range", f),
                      ("from_unit_range", f)):
        got = getattr(tiops, name)(torch.from_numpy(arg)).numpy()
        want = np.asarray(getattr(jiops, name)(jnp.asarray(arg)))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("shape,size", [((2, 32, 40, 3), (16, 12)), ((2, 32, 40, 3), (64, 70)),
                                        ((3, 17, 23), (9, 31)), ((2, 5, 24, 24), (7, 50))],
                         ids=["hwc-down", "hwc-up", "hw-mixed", "chw-mixed"])
def test_resize_bilinear_matches_jax(shape, size):
    """resize_bilinear on (..., H, W, C) with C in (1, 3, 4) and on the last
    two axes otherwise, down (antialiased, as jax.image.resize is) and up:
    within 1e-6 (measured 1.8e-7)."""
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    got = tiops.resize_bilinear(torch.from_numpy(x), *size).numpy()
    want = np.asarray(jiops.resize_bilinear(jnp.asarray(x), *size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_tree_finite_and_cast_floats_match_jax():
    """tree_finite: True on a finite tree (integer leaves count as finite),
    False with one NaN or inf, as JAX's; cast_floats on a dict tree casts the
    floating leaves and skips the named keys, as JAX's; on a module it casts
    parameters and buffers in place, the w8 scale rows kept float32."""
    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.arange(4, dtype=np.int32),
                                                  "w8_scale": np.full((1, 3), 0.5, np.float32)}}
    assert bool(ttree.tree_finite(tree)) and bool(jtree.tree_finite(tree))
    for bad in (np.nan, np.inf):
        t = {"a": tree["a"].copy(), "b": tree["b"]}
        t["a"][1, 2] = bad
        assert not bool(ttree.tree_finite(t)) and not bool(jtree.tree_finite(t))
    assert bool(ttree.tree_finite({})) and bool(jtree.tree_finite({}))
    got = ttree.cast_floats(tree, torch.bfloat16)
    want = jtree.cast_floats(tree, jnp.bfloat16, skip_keys=("w8_scale",))
    assert got["a"].dtype == torch.bfloat16 and want["a"].dtype == jnp.bfloat16
    assert got["b"]["c"].dtype == torch.int32 and got["b"]["w8_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["a"].float().numpy(), np.asarray(want["a"], np.float32))
    from contextual_image_compression_tpu_torch.models.layers import KDense, prepare_w8

    dense = KDense(8, 4, w8=True)  # a module with a w8 scale row
    prepare_w8(dense)
    assert ttree.cast_floats(dense, torch.bfloat16) is dense
    assert dense.bias.dtype == torch.bfloat16 and dense.w8_scale.dtype == torch.float32
    assert bool(ttree.tree_finite(dense))


def test_version_matches_jax():
    assert tversion == jversion == "0.1.0"


# ------------------------------------------------------------------ CLIs


def _port_main(script):
    return runpy.run_path(str(SCRIPTS / script))["main"]


def _run_jax_script(script, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(SCRIPTS / script)] + argv)
    try:
        runpy.run_path(str(SCRIPTS / script), run_name="__main__")
    except SystemExit as e:
        if e.code:
            raise


def _rd_csv(path, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Target BPP", "Actual BPP", "Measured BPP", "PSNR", "SSIM", "HQ Ratio (%)"])
        for bpp in (0.1, 0.5, 1.0, 2.0):
            w.writerow([bpp, rng.rand(), "" if seed % 2 else rng.rand(), 20 + 10 * rng.rand(),
                        rng.rand(), 100 * rng.rand()])


def test_compare_rd_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    """The same markdown table and PSNR deltas on stdout, character for
    character, from the same CSVs (three runs, one with an empty column);
    --plot where matplotlib imports writes the PNG, and raises naming
    matplotlib where it does not, after the table."""
    runs = []
    for i, label in enumerate(("base", "ste", "fixed")):
        _rd_csv(tmp_path / f"{label}.csv", i)
        runs.append(f"{label}={tmp_path / f'{label}.csv'}")
    _run_jax_script("compare_rd.py", runs, monkeypatch)
    want = capsys.readouterr().out
    assert _port_main("torch_compare_rd.py")(runs, device="cpu") == 0
    got = capsys.readouterr().out
    assert got == want and "PSNR delta at matched target bpp" in got
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="matplotlib"):
            _port_main("torch_compare_rd.py")(runs + ["--plot", str(tmp_path / "rd.png")])
    else:
        _port_main("torch_compare_rd.py")(runs + ["--plot", str(tmp_path / "rd.png")])
        assert (tmp_path / "rd.png").stat().st_size > 0
    assert capsys.readouterr().out.startswith(want)


def _synthetic_vgg_state(seed=0):
    """A torchvision-style VGG19 `features` state dict of random weights."""
    gen = torch.Generator().manual_seed(seed)
    state, idx, cin = {}, 0, 3
    for width, n in tvgg.VGG19_LAYOUT:
        for _ in range(n):
            state[f"features.{idx}.weight"] = torch.randn(width, cin, 3, 3, generator=gen) * 0.05
            state[f"features.{idx}.bias"] = torch.randn(width, generator=gen) * 0.01
            cin, idx = width, idx + 2
        idx += 1
    return state


def _write_h5(path, state):
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        idx = 0
        for bi, (_, n) in enumerate(tvgg.VGG19_LAYOUT, start=1):
            for ci in range(1, n + 1):
                name = f"block{bi}_conv{ci}"
                inner = root.create_group(name).create_group(name)
                inner["kernel:0"] = state[f"features.{idx}.weight"].numpy().transpose(2, 3, 1, 0)
                inner["bias:0"] = state[f"features.{idx}.bias"].numpy()
                idx += 2
            idx += 1


@pytest.mark.parametrize("kind", ["pth", "h5"])
def test_convert_vgg_weights_matches_jax(kind, tmp_path, monkeypatch, capsys):
    """On the same synthetic VGG19 file (torchvision .pth with its hash
    prefix in the name, or keras .h5), both scripts write the same keys and
    the same weight arrays bit for bit; the stored fingerprints agree within
    1e-3 relative (measured 9.9e-5: two stacks of 16 float32 convolutions
    summed in other orders; the loaders' own bar is 2e-2); each
    package's load_vgg19_features accepts the other's file. A file name whose
    hash prefix does not match its bytes stops both scripts."""
    state = _synthetic_vgg_state()
    if kind == "pth":
        raw = tmp_path / "raw.pth"
        torch.save(state, raw)
        digest = hashlib.sha256(raw.read_bytes()).hexdigest()
        src = tmp_path / f"vgg19-{digest[:8]}.pth"
        raw.rename(src)
        bad = tmp_path / "vgg19-00000000.pth"
        bad.write_bytes(src.read_bytes())
        with pytest.raises(SystemExit, match="hash prefix"):
            _port_main("torch_convert_vgg_weights.py")([str(bad), str(tmp_path / "x.npz")],
                                                      device="cpu")
        with pytest.raises(SystemExit, match="hash prefix"):
            _run_jax_script("convert_vgg_weights.py", [str(bad), str(tmp_path / "x.npz")],
                            monkeypatch)
    else:
        pytest.importorskip("h5py")
        src = tmp_path / "vgg19_notop.h5"
        _write_h5(src, state)
    tout, jout = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert _port_main("torch_convert_vgg_weights.py")([str(src), str(tout)], device="cpu") == 0
    _run_jax_script("convert_vgg_weights.py", [str(src), str(jout)], monkeypatch)
    printed = capsys.readouterr().out
    assert printed.count("loader fingerprint re-verification: OK") == 2
    with np.load(tout) as t, np.load(jout) as j:
        assert list(t.keys()) == list(j.keys())
        for key in t.keys():
            if key == tvgg.FINGERPRINT_KEY:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-3)
            else:
                assert t[key].dtype == j[key].dtype
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert tvgg.load_vgg19_features(str(jout), device="cpu") is not None
    assert jvgg.load_vgg19_features(str(tout)) is not None


def _tiny_config(monkeypatch):
    monkeypatch.setattr(tconfig, "ModelConfig", functools.partial(tconfig.ModelConfig, **TINY_KW))


def _jax_keys(script, pattern):
    return set(re.findall(pattern, (SCRIPTS / script).read_text()))


def test_profile_codec_prints_the_jax_keys(tmp_path, monkeypatch, capsys):
    """torch_profile_codec.py at the tiny widths on the CPU: one JSON line
    with the JAX script's keys (its run(...) rows, batch, backend), every
    row a positive images/s; --trace writes a Chrome trace; the attention
    rows take K2's twin and the jnp formula (the twin runs only for
    attention_pallas)."""
    _tiny_config(monkeypatch)
    calls = []
    twin = tops.attention.attention_block_plain
    monkeypatch.setattr(tops.attention, "attention_block_plain",
                        lambda *a: calls.append(1) or twin(*a))
    trace = tmp_path / "trace"
    assert _port_main("torch_profile_codec.py")(
        ["--batch", "2", "--iters", "2", "--trace", str(trace)], device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    want = _jax_keys("profile_codec.py", r'run\("([^"]+)"') | {"batch", "backend"}
    assert set(out) == want and len(want) == 11
    assert out["batch"] == 2 and out["backend"] == "cpu"
    assert all(out[k] > 0 for k in want - {"batch", "backend"})
    assert len(list(trace.glob("*.json"))) == 1
    assert calls  # codec_full, encoder_hq and attention_pallas reach K2's twin


def test_layer_microbench_prints_the_jax_keys(monkeypatch, capsys):
    """torch_layer_microbench.py at the tiny widths on the CPU: one JSON line
    with the JAX script's layer names (convs and deconvs with ms,
    gmacs_per_img and tflops; poly, tail and dense rows with ms and tflops)."""
    _tiny_config(monkeypatch)
    assert _port_main("torch_layer_microbench.py")(["--batch", "2", "--iters", "2"],
                                                   device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = _jax_keys("layer_microbench.py", r'"((?:enc|gen|poly|tail)\.[a-z_0-9]+)"')
    assert set(out) == names | {"batch"} and len(names) == 19
    for name in names:
        keys = {"ms", "gmacs_per_img", "tflops"} if name[:4] in ("enc.", "gen.") and \
            "dense" not in name else {"ms", "tflops"}
        assert set(out[name]) == keys and out[name]["ms"] > 0, name


def test_mesh_scaling_records_equal_losses(tmp_path):
    """scripts/torch_mesh_scaling.py at world sizes 1 and 2 (gloo ranks on
    the CPU): the batch sharded 1 / D, the same losses at both sizes within
    the JAX script's bar, written where asked and never to JAX's record."""
    import os
    import subprocess

    out = tmp_path / "mesh_scaling_torch.json"
    script = str(Path(__file__).resolve().parent.parent / "scripts" / "torch_mesh_scaling.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    res = subprocess.run([sys.executable, script, "--world-sizes", "1,2", "--steps", "1",
                          "--global-batch", "8", "--out", str(out)], env=env, timeout=600,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert res.returncode == 0, res.stdout[-4000:]
    rec = json.loads(out.read_text())
    one, two = rec["per_world_size"]["1"], rec["per_world_size"]["2"]
    assert two["mesh"] == {"data": 2, "model": 1}
    assert one["per_rank_batch_shard"][0] == 8 and two["per_rank_batch_shard"][0] == 4
    for k, v in one["losses"].items():
        assert abs(two["losses"][k] - v) <= 1e-4 + 1e-3 * abs(v), k
    refused = subprocess.run([sys.executable, script, "--out", str(Path(script).parent.parent
                                                                   / "runs" / "mesh_scaling.json")],
                             env=env, timeout=300, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    assert refused.returncode != 0 and "JAX script" in refused.stdout
