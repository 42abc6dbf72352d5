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


# --- the card's bf16 route: a numpy emulation of its paired walk -----------
#
# csrc/fused_mask.cu's cluster route computes two horizontally adjacent
# outputs a thread as one bf16x2 register. Its lanes round as scalars do, so
# what can go wrong is which strip values each lane reads: the halo lanes and
# straddled pairs of the box sums, the masked lane of an odd width, the
# reflected-column pairs, the Gaussian's pairs, the thread loops' coverage
# and the halo rows from neighbouring blocks. `_emulate_k1_bf16_cluster`
# walks the kernel's indices as written (threads, warp tasks, lanes) with
# numpy float32 values rounded to bf16 after each bf16 operation, and must
# give the bf16 twin's mask bit for bit.

def _rb(x):
    """float32 -> bf16 (nearest even) -> float32."""
    u = np.array(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _add(a, b):
    return _rb(np.float32(a) + np.float32(b))


def _mul(a, b):
    return _rb(np.float32(a) * np.float32(b))


def _sub(a, b):
    return _rb(np.float32(a) - np.float32(b))


def _chunk_add(terms):
    """chunk_add2 over terms 0 .. n - 1: the total starts at 0."""
    total, part = np.zeros_like(terms[0]), None
    for i, t in enumerate(terms):
        part = t if i % CHUNK == 0 else _add(part, t)
        if i % CHUNK == CHUNK - 1 or i == len(terms) - 1:
            total = _add(total, part)
    return total


def _reflect(i, n):
    i = abs(i)
    i = 2 * n - 2 - i if i >= n else i
    return min(max(i, 0), n - 1)


def _norm(x, m):
    return x / np.float32(max(m, np.float32(1e-12))) if m > 0 else x


def _pair_threads(n, w, rows_per_thread):
    """The (first row, first column) a thread of the kernel's pair stages
    takes: WP pairs of columns x YP rows, striding as the loops do."""
    wp = min(512, ((w + 1) // 2 + 31) & ~31)
    yp_n = 512 // wp
    out = []
    for tid in range(512):
        if tid // wp >= yp_n:
            continue
        for y0 in range((tid // wp) * rows_per_thread, n, yp_n * rows_per_thread):
            for x in range(2 * (tid % wp), w, 2 * wp):
                out.append((y0, x))
    return out


def _emulate_k1_bf16_cluster(gray, spec, scales=(1, 2, 3, 4, 5, 6)):
    """One image (H, W) through the cluster route's bf16 walk."""
    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        _halo_rows, _mask_plan, upsample_taps)

    h, w = gray.shape
    rmax, rad, ks = max(scales), 4, 31
    gpad = ks // 2
    plan = _mask_plan(h, w, rmax, rad, ks)
    assert plan.route == "cluster"
    taps = [(dy, dx, bf16_value(sw), bf16_value(swc))
            for dy, dx, sw, swc in tiops.bilateral_taps(9, 75.0, 75.0)]
    gk = [bf16_value(v) for v in tiops.gaussian_kernel_1d(ks, 0.0)]
    ranks = [(r, r * plan.rows, min(plan.rows, h - r * plan.rows)) for r in range(plan.cluster)]
    g = _rb(gray * np.float32(1.0 / 255.0))

    def staged(strips, halo, x_lo, x_hi, rank, fix, col0=None):
        """Buffer 0 of block `rank`: its rows and `halo` rows each side from
        the owning blocks' strips, columns x_lo .. x_hi - 1 at index x + col0
        (default halo; reflected), zero where the stage does not stage."""
        col0 = halo if col0 is None else col0
        rows = _halo_rows(plan, h, rank, halo)
        buf = np.zeros((len(rows) + 3, w + 2 * col0 + 2), np.float32)
        for j, (yy, owner, row) in enumerate(rows):
            assert yy == owner * plan.rows + row
            for x in range(x_lo, x_hi):
                buf[j, x + col0] = fix(strips[owner][row, _reflect(x, w)])
        return buf

    # stage 1: warp tasks of 32 lanes, a pair of columns a lane, hl halo
    # lanes; g staged in columns -hw .. w + hw, a lane's pair at its even
    # column, clamped into them
    gstrips = [g[r0:r0 + n] for _, r0, n in ranks]
    hl = (rmax + 1) // 2
    hw = 2 * hl
    span = 2 * (32 - 2 * hl)
    nseg = -(-w // span)
    lane = np.arange(32)
    x = np.arange(nseg)[:, None] * span + 2 * (lane - hl)  # (nseg, 32)
    ca = np.clip(x, -hw, (w + hw - 1) & ~1) + hw
    cb = ca + 1
    fine = []
    for rank, _, n in ranks:
        b0 = staged(gstrips, rmax, -hw, w + hw + 1, rank, lambda v: v, col0=hw)

        def at(dy):
            rows = b0[np.arange(n) + rmax + dy]
            return np.stack([rows[:, ca], rows[:, cb]], -1)  # (n, nseg, 32, 2)

        gp = at(0)
        v, f = gp, np.zeros_like(gp)
        for r in range(1, rmax + 1):
            v = _add(_add(v, at(-r)), at(r))
            if r not in scales:
                continue
            nb = {k: v[:, :, (lane + k) % 32] for k in range(-4, 5) if 2 * abs(k) <= r + 1}
            terms = [np.stack([nb[dx // 2][..., 1], nb[dx // 2 + 1][..., 0]], -1) if dx % 2
                     else nb[dx // 2] for dx in range(-r, r + 1)]
            inv = _rb(np.float32(1.0) / np.float32((2 * r + 1) ** 2))
            f = _add(f, np.abs(_sub(gp, _mul(_chunk_add(terms), inv))))
        out = np.full((n, w), np.nan, np.float32)
        valid = (lane >= hl) & (lane < 32 - hl) & (x < w)
        for e in (0, 1):
            ok = valid & (x + e < w)
            cols = np.broadcast_to(x + e, f.shape[:3])[:, ok]
            assert np.isnan(out[:, cols[0]]).all()  # each column once
            out[:, cols[0]] = f[:, ok, e]
        assert not np.isnan(out).any()
        fine.append(out)
    m1 = max(float(s.max()) for s in fine)

    # stage 2: float32 a lane
    ih, wh = upsample_taps(spec.shape[0], h)
    iw, ww = upsample_taps(spec.shape[1], w)
    i1 = np.minimum(ih + 1, spec.shape[0] - 1)
    j1 = np.minimum(iw + 1, spec.shape[1] - 1)
    a0, a1 = wh[:, :1], wh[:, 1:]
    t0 = a0 * spec[ih][:, iw] + a1 * spec[i1][:, iw]
    t1 = a0 * spec[ih][:, j1] + a1 * spec[i1][:, j1]
    up = t0 * ww[:, 0] + t1 * ww[:, 1]
    comb = np.float32(0.6) * up + np.float32(0.4) * _norm(np.concatenate(fine), m1)
    m2 = float(comb.max())
    cstrips = [comb[r0:r0 + n] for _, r0, n in ranks]

    # stage 3: two rows x a pair of columns a thread; the union of the two
    # disks in (dy, dx) order gives each row the twin's tap order
    t0 = t1 = 0
    for dy in range(-rad, rad + 2):
        for dx in range(-rad, rad + 1):
            if dy <= rad and dy * dy + dx * dx <= rad * rad:
                assert taps[t0][:2] == (dy, dx)
                t0 += 1
            if dy > -rad and (dy - 1) ** 2 + dx * dx <= rad * rad:
                assert taps[t1][:2] == (dy - 1, dx)
                t1 += 1
    bil = []
    for rank, _, n in ranks:
        b0 = staged(cstrips, rad, -rad, w + rad, rank, lambda v: _rb(_norm(v, m2)))
        out = np.full((n, w), np.nan, np.float32)
        for y0, x in _pair_threads(n, w, 2):
            for y in (y0, y0 + 1)[:2 if y0 + 1 < n else 1]:
                c = b0[y + rad, [x + rad, x + 1 + rad]]
                pn = pd = num = den = None
                sums = []
                for t, (dy, dx, sw, swc) in enumerate(taps):
                    sh = b0[y + rad + dy, [x + dx + rad, x + dx + 1 + rad]]
                    diff = _sub(sh, c)
                    wgt = _add(np.float32(sw), _mul(np.float32(swc), _mul(diff, diff)))
                    sums.append((_mul(wgt, sh), wgt))
                num = _chunk_add([s[0] for s in sums])
                den = _chunk_add([s[1] for s in sums])
                ratio = _rb(num / np.maximum(den, np.float32(1e-20)))
                for e in (0, 1):
                    if x + e < w:
                        assert np.isnan(out[y, x + e])
                        out[y, x + e] = ratio[e]
        assert not np.isnan(out).any()
        bil.append(out)

    # stage 4: four rows x a pair a thread, then the reflected-column pairs
    rstrips = []
    for rank, _, n in ranks:
        b0 = staged(bil, gpad, 0, w, rank, lambda v: v)
        # column x at x + gpad; the last group of stage 5 reads past the
        # reflected columns (the kernel, into the next row) for outputs it
        # does not store
        out = np.full((n, w + 2 * gpad + 8), np.nan, np.float32)
        for y0, x in _pair_threads(n, w, 4):
            for o in range(4):
                if y0 + o < n:
                    terms = [_mul(np.float32(gk[i]), b0[y0 + o + i, [x + gpad, x + 1 + gpad]])
                             for i in range(ks)]
                    s = _chunk_add(terms)
                    for e in (0, 1):
                        if x + e < w:
                            assert np.isnan(out[y0 + o, x + e + gpad])
                            out[y0 + o, x + e + gpad] = s[e]
        for i in range(n * gpad):
            y, k = i // gpad, 2 * (i % gpad)
            xa = k - gpad if k < gpad else w + k - gpad
            xb = k + 1 - gpad if k + 1 < gpad else w + k + 1 - gpad
            src = [_reflect(xa, w) + gpad, _reflect(xb, w) + gpad]
            s = _chunk_add([_mul(np.float32(gk[t]), b0[y + t, src]) for t in range(ks)])
            for xx, val in ((xa, s[0]), (xb, s[1])):
                assert np.isnan(out[y, xx + gpad])
                out[y, xx + gpad] = val
        assert not np.isnan(out[:, :w + 2 * gpad]).any()
        rstrips.append(np.nan_to_num(out))

    # stage 5: four columns a thread as two pairs; pair o's tap t is the pair
    # (row[t + 2o], row[t + 2o + 1])
    final = []
    for (rank, _, n), b1 in zip(ranks, rstrips):
        out = np.full((n, w), np.nan, np.float32)
        for x0 in range(0, w, 4):
            q = [b1[:, [x0 + t, x0 + t + 1]] for t in range(ks + 2)]  # row[t] = b1[x0 - gpad + t]
            for o in range(2):
                s = _chunk_add([_mul(np.float32(gk[t]), q[t + 2 * o]) for t in range(ks)])
                for e in (0, 1):
                    if x0 + 2 * o + e < w:
                        out[:, x0 + 2 * o + e] = s[:, e]
        final.append(out)
    out = np.concatenate(final)
    assert not np.isnan(out).any()
    return _norm(out, float(out.max()))


@pytest.mark.parametrize("shape", [(40, 61), (36, 64)])
def test_card_bf16_pair_walk_is_the_twin(shape):
    """The cluster route's paired bf16 walk, emulated lane by lane (odd
    width 61: the last pair's right lane masked, two box-sum warp tasks a
    row; 36 rows: blocks of 6 rows whose halos span several blocks), equals
    the bf16 twin bit for bit."""
    h, w = shape
    rng = np.random.RandomState(h * w)
    gray = (rng.rand(h, w) * 255).astype(np.float32)
    spec = rng.rand(16, 16).astype(np.float32)
    got = _emulate_k1_bf16_cluster(gray, spec)
    want = _twin(gray[None], spec[None])[0]
    np.testing.assert_array_equal(got, want)
