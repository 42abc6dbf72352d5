"""K1's bf16 route (SaliencyConfig.mask_engine_dtype='bfloat16') against the
JAX package's `contextual_mask_pallas(..., compute_dtype=bfloat16)`.

On the CPU the port's wrapper runs the bf16 twin
(`ops/fused_mask.py::_contextual_mask_plain_bf16`), which rounds every bf16
operation to bf16 in the TPU kernel's order and chunking; the JAX kernel runs
in interpret mode, as tests/test_fused_mask.py runs it. XLA on the CPU holds
fused bf16 chains in float32 (its excess-precision default), so in this
process the two differ by bf16 roundings: at 64^2 the largest difference
measured was 1.47e-2 with ~81-85% of pixels identical, so the bar is 2e-2
and 75%. With that default off (XLA_FLAGS=--xla_allow_excess_precision=false,
in a subprocess, since the flag must be set before JAX starts) XLA rounds
each operation too, and the JAX kernel and the twin are bit-identical: that
case holds the twin's order, chunking and constants to the TPU kernel's. The
bf16 mask stays within JAX's own 5e-2 of the float32 mask
(tests/test_fused_mask.py). Inputs are made from numpy seeds.
"""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu.ops.fused_mask import contextual_mask_pallas
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.config import SaliencyConfig
from contextual_image_compression_tpu_torch.ops import image_ops as tiops
from contextual_image_compression_tpu_torch.ops import masks as tmasks
from contextual_image_compression_tpu_torch.ops import saliency as tsal
from contextual_image_compression_tpu_torch.ops.fused_mask import (
    CHUNK,
    bf16_value,
    contextual_mask,
    contextual_mask_plain,
    upsample_two_tap,
)

REPO = Path(__file__).resolve().parent.parent
CASES = {"small-spec": 32, "full-spec": 64}  # the spectral map's size at 64^2 images


def _inputs(spec_size, seed=0):
    rng = np.random.RandomState(seed + spec_size)
    gray = (rng.rand(2, 64, 64) * 255).astype(np.float32)
    spec = rng.rand(2, spec_size, spec_size).astype(np.float32)
    return gray, spec


def _twin(gray, spec, dtype=torch.bfloat16):
    return contextual_mask_plain(torch.from_numpy(gray), torch.from_numpy(spec),
                                 compute_dtype=dtype).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_twin_matches_pallas_interpret(case):
    """The twin against the JAX kernel in interpret mode, in this process:
    within 2e-2, >= 75% of pixels identical (what XLA's excess precision
    leaves); both within 5e-2 of the float32 mask."""
    gray, spec = _inputs(CASES[case])
    got = _twin(gray, spec)
    want = np.asarray(contextual_mask_pallas(jnp.asarray(gray), jnp.asarray(spec),
                                             compute_dtype=jnp.bfloat16))
    assert got.shape == (2, 64, 64) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-2
    assert np.mean(got == want) >= 0.75
    f32 = _twin(gray, spec, torch.float32)
    assert 1e-3 < np.abs(got - f32).max() <= 5e-2  # the bf16 route does round
    assert np.abs(want - f32).max() <= 5e-2


def test_bf16_twin_is_bitwise_the_kernel_without_excess_precision(tmp_path):
    """With XLA's excess precision off, the JAX kernel rounds each bf16
    operation as the twin does: bit-identical masks, with and without the
    in-kernel upsample of the small spectral map."""
    inputs = {case: _inputs(size) for case, size in CASES.items()}
    np.savez(tmp_path / "in.npz", **{f"{c}_{k}": a for c, (g, s) in inputs.items()
                                     for k, a in (("gray", g), ("spec", s))})
    script = textwrap.dedent(f"""
        import numpy as np, jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from contextual_image_compression_tpu.ops.fused_mask import contextual_mask_pallas
        d = np.load({str(tmp_path / "in.npz")!r})
        out = {{}}
        for c in {list(CASES)!r}:
            out[c] = np.asarray(contextual_mask_pallas(
                jnp.asarray(d[c + "_gray"]), jnp.asarray(d[c + "_spec"]),
                compute_dtype=jnp.bfloat16))
        np.savez({str(tmp_path / "out.npz")!r}, **out)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c", script], check=True, env=env, cwd=REPO, timeout=600)
    want = np.load(tmp_path / "out.npz")
    for case, (gray, spec) in inputs.items():
        np.testing.assert_array_equal(_twin(gray, spec), want[case], err_msg=case)


def test_bf16_constants_round_as_jax():
    """The twin's and the kernel's bf16 constants (1 / k^2, the bilateral's
    sw and swc, the Gaussian taps) are jnp.asarray(v, bfloat16)."""
    vals = [1.0 / (k * k) for k in range(3, 14, 2)]
    for _, _, sw, swc in tiops.bilateral_taps(9, 75.0, 75.0):
        vals += [sw, swc]
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            if dy * dy + dx * dx <= 16:
                sw = math.exp(-0.5 / (75.0 * 75.0) * (dy * dy + dx * dx))
                vals += [sw, sw * (-0.5 / (75.0 * 75.0))]
    vals += [float(v) for v in tiops.gaussian_kernel_1d(31, 0.0)]
    got = np.array([bf16_value(v) for v in vals], np.float32)
    want = np.array([float(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)) for v in vals],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    assert CHUNK == 8


def test_upsample_two_tap_matches_the_linear_resize():
    """The bf16 route's two-tap upsample is the linear resize (the float32
    route's operator matrices) to float32 rounding."""
    spec = torch.from_numpy(np.random.RandomState(3).rand(2, 64, 64).astype(np.float32))
    from contextual_image_compression_tpu_torch.ops.fused_mask import resize_spectral

    np.testing.assert_allclose(upsample_two_tap(spec, 256, 256).numpy(),
                               resize_spectral(spec, 256, 256).numpy(), atol=1e-6)


def test_wrapper_runs_the_bf16_twin_on_the_cpu():
    """contextual_mask(compute_dtype=bfloat16) on CPU tensors is the twin, with
    no launch counted; other dtypes raise."""
    gray, spec = _inputs(32)
    g, s = torch.from_numpy(gray), torch.from_numpy(spec)
    before = tops.launch_counts()
    got = contextual_mask(g, s, compute_dtype=torch.bfloat16).numpy()
    assert tops.launch_counts() == before
    np.testing.assert_array_equal(got, _twin(gray, spec))
    with pytest.raises(ValueError):
        contextual_mask(g, s, compute_dtype=torch.float16)


@pytest.mark.parametrize("wire", ["uint8", "float"])
def test_compute_contextual_mask_bf16_engine(wire):
    """SaliencyConfig(mask_engine_dtype='bfloat16') with 'combined' and the
    smooth mask runs the bf16 route on gray255 and the 64^2 spectral map, as
    JAX's fused path does (the upsample inside)."""
    rng = np.random.RandomState(17)
    u8 = (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)
    images = torch.from_numpy(u8) if wire == "uint8" else torch.from_numpy(
        u8.astype(np.float32) / 127.5 - 1.0)
    cfg = SaliencyConfig(mask_engine_dtype="bfloat16")
    got = tmasks.compute_contextual_mask(images, cfg).numpy()
    if wire == "uint8":
        gray = tiops.rgb_to_gray(images.to(torch.float32))
    else:
        gray = tsal._as_gray(images)
    spec = tsal.spectral_residual_small(gray, 64, 3.0)
    want = contextual_mask_plain(gray, spec, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(got, want)
    f32 = tmasks.compute_contextual_mask(images, SaliencyConfig()).numpy()
    assert np.abs(got - f32).max() <= 5e-2
