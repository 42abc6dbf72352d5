"""The launch plan of the mask kernels K1 / K4 (`ops/fused_mask.py::_mask_plan`)
and the quantizer's launch path (`ops/quantize.py::adaptive_quantize`), on the
CPU.

The cluster route gives each image one thread-block cluster whose blocks own
strips of whole rows; a stage with a halo reads the rows above and below its
strip from the blocks that own them, after reflect-101 at the image's edges.
These tests hold the plan's sizes and that row arithmetic against numpy; the
kernels themselves are held against their twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest
import torch

from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.config import QuantizerConfig
from contextual_image_compression_tpu_torch.ops import cuda_kernels
from contextual_image_compression_tpu_torch.ops.fused_mask import (
    MAX_SMEM_BYTES,
    _halo_rows,
    _mask_plan,
)
from contextual_image_compression_tpu_torch.ops.quantize import (
    adaptive_quantize,
    adaptive_quantize_bwd_plain,
    adaptive_quantize_plain,
)

# (rmax, bilateral radius, Gaussian size) of K1 and K4 at the defaults
K1_FILTERS = (6, 4, 31)
K4_FILTERS = (0, 4, 31)


@pytest.mark.parametrize("filters", [K1_FILTERS, K4_FILTERS], ids=["K1", "K4"])
def test_default_size_takes_the_cluster_route(filters):
    """256^2 (serving, training and the mask path): 6 blocks of 43 rows per
    image (the last owning 41), within a block's shared memory."""
    plan = _mask_plan(256, 256, *filters)
    assert plan.route == "cluster"
    assert (plan.cluster, plan.rows) == (6, 43)
    assert plan.smem_bytes <= MAX_SMEM_BYTES == 232448
    assert plan.stride % 2 == 1 and plan.stride >= 256 + 2 * plan.halo
    assert plan.halo == 15  # the Gaussian's 31 taps


@pytest.mark.parametrize("filters", [K1_FILTERS, K4_FILTERS], ids=["K1", "K4"])
def test_large_images_take_the_tiled_route(filters):
    plan = _mask_plan(512, 512, *filters)
    assert plan.route == "tiled"
    assert plan.smem_bytes > MAX_SMEM_BYTES
    assert _mask_plan(290, 290, *filters).cluster == 6
    assert _mask_plan(300, 300, *filters).cluster == 8  # 6 strips would not fit
    assert _mask_plan(335, 335, *filters).route == "cluster"
    assert _mask_plan(336, 336, *filters).route == "tiled"


@pytest.mark.parametrize("h", [32, 30, 48, 50, 57, 26, 256, 200])
def test_ranks_cover_the_rows_and_the_last_may_own_fewer(h):
    """Every rank owns at least one row, the ranks tile [0, h) in order, and
    only the last owns fewer than `rows` (h not a multiple of the cluster)."""
    plan = _mask_plan(h, 64, *K1_FILTERS)
    assert 1 <= plan.cluster <= 8
    owned = [min(plan.rows, h - r * plan.rows) for r in range(plan.cluster)]
    assert min(owned) >= 1 and sum(owned) == h
    assert all(n == plan.rows for n in owned[:-1])
    assert (owned[-1] < plan.rows) == (h % plan.rows != 0)


@pytest.mark.parametrize("halo", [6, 4, 15], ids=["box", "bilateral", "gaussian"])
@pytest.mark.parametrize("h", [32, 30])
def test_halo_rows_and_owners_match_numpy_reflect(h, halo):
    """At 32 x 64 a strip is 6 rows (the last rank owns 2), so the Gaussian's
    15 halo rows come from ranks up to 3 away and reflect at the top and
    bottom into rows other ranks own; at 30 rows every rank owns 5."""
    plan = _mask_plan(h, 64, *K1_FILTERS)
    assert plan.rows == (6 if h == 32 else 5)
    padded = np.pad(np.arange(h), halo, mode="reflect")
    far = 0
    for rank in range(plan.cluster):
        r0 = rank * plan.rows
        n = min(plan.rows, h - r0)
        rows = _halo_rows(plan, h, rank, halo)
        assert [yy for yy, _, _ in rows] == padded[r0:r0 + n + 2 * halo].tolist()
        for yy, owner, local in rows:
            assert 0 <= owner < plan.cluster
            assert 0 <= local < min(plan.rows, h - owner * plan.rows)
            assert owner * plan.rows + local == yy
            far = max(far, abs(owner - rank))
    assert far >= 3 if halo == 15 else far >= 1


def test_kernel_checks_the_plans_layout():
    """csrc/fused_mask.cu refuses a plan whose shared-memory size is not its
    own layout's; both sides count the same buffers."""
    src = (cuda_kernels.CSRC_DIR / "fused_mask.cu").read_text()
    assert re.search(r"return \(size_t\)\(3 \* rows \+ 2 \* halo \+ 3\) \* stride \+ 4 \+ 32;", src)
    plan = _mask_plan(256, 256, *K1_FILTERS)
    assert plan.smem_bytes == 4 * ((3 * plan.rows + 2 * plan.halo + 3) * plan.stride + 4 + 32)
    assert "CL_MAX_CLUSTER = 8" in src


def _quant_inputs(dtype, shape_1d=False, seed=5):
    rng = np.random.RandomState(seed)
    z = torch.from_numpy((rng.randn(16, 512) * 2).astype(np.float32)).to(dtype)
    s = torch.from_numpy(rng.rand(16, 1).astype(np.float32)).to(dtype)
    q = torch.from_numpy((rng.rand(16, 1) * 0.9).astype(np.float32)).to(dtype)
    if shape_1d:
        s, q = s.reshape(16), q.reshape(16)
    return z, s, q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_quantize_without_grad_skips_autograd(dtype, requires_grad):
    """Under torch.no_grad() (how serving calls it) the result has no
    grad_fn, even for inputs that require grad, and equals the twin bit for
    bit; on the CPU nothing launches."""
    z, s, q = (t.requires_grad_(requires_grad) for t in _quant_inputs(dtype))
    before = tops.launch_counts()
    with torch.no_grad():
        out = adaptive_quantize(z, s, q, QuantizerConfig(grad_mode="reference"))
    assert out.grad_fn is None and not out.requires_grad
    assert out.dtype == dtype
    assert torch.equal(out, adaptive_quantize_plain(z.detach(), s.detach(), q.detach()))
    assert tops.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape_1d", [False, True], ids=["B1", "B"])
def test_quantize_with_grad_keeps_the_reference_backward(dtype, shape_1d):
    """With inputs that need a gradient the autograd Function runs: the
    latent gets zero, score and strength get the twin's gradients in their
    own dtypes and shapes ((B, 1) or (B,)), bit for bit on the CPU."""
    z, s, q = _quant_inputs(dtype, shape_1d, seed=8)
    g = torch.from_numpy(np.random.RandomState(9).randn(16, 512).astype(np.float32)).to(dtype)
    ts = [t.clone().requires_grad_(True) for t in (z, s, q)]
    out = adaptive_quantize(*ts, QuantizerConfig(grad_mode="reference"))
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), adaptive_quantize_plain(z, s, q))
    out.backward(g)
    ds, dq = adaptive_quantize_bwd_plain(z, s, q, g)
    assert not ts[0].grad.any()
    for got, want, ref in ((ts[1].grad, ds, s), (ts[2].grad, dq, q)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, want)
