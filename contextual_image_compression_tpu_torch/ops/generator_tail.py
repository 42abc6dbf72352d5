"""K8: the generator's fused inference tail, and its plain PyTorch twin.

K8 replaces `contextual_image_compression_tpu/models/packed_tail.py::
fused_tail_pallas`, which `packed_tail_forward(use_pallas=True)` reaches:
BN-folded 4x4/s2 transposed conv -> + shift -> LeakyReLU -> zeros outside
the image -> 4x4/s1 SAME conv -> + bias -> tanh, in NCHW. `fused_tail`
launches the kernel in `csrc/packed_tail.cu` for CUDA tensors (the deconv's
tap products and the out-conv on the tensor cores: bf16 in one pass, route
"wgmma"; float32 in three TF32 passes, route "tf32x3") and runs the twin
`fused_tail_plain` for CPU tensors. The twin keeps the TPU kernel's
roundings: each of the four polyphase tap products rounded to the compute
dtype and added into a dtype accumulator in the kernel's order, LeakyReLU in
float32, the out-conv in float32. Inference only (no backward), as in JAX.

`int8_tail` is K8's third route, "int8": the serving tail in its int8 form
(`packed_tail_forward(int8_planar=True)`, the XLA path JAX serves with) on
bf16 CUDA tensors, from operands folded once (`models/packed_tail.py::
fold_int8_tail`). It keeps that path's roundings, not the TPU kernel's: the
deconv summed over all four taps and Cin in float32 and rounded to bf16
once, + shift and LeakyReLU in bf16, q = clamp(rint(y * 127 / amax), +-127),
the out-conv on q rounded to bf16, + bias in bf16, tanh. Its eager twin is
that path itself (`models/packed_tail.py::int8_tail_plain`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck


def _tap(a: int, r: int):
    """Phase a of the 4x4/s2 transposed conv, tap r: (input offset, index of
    the port's flipped conv_transpose2d kernel). Output pixel 2i + a reads
    x[i + a + r - 1] through kernel index 3 - a - 2r."""
    return a + r - 1, 3 - a - 2 * r


def fused_tail_plain(x, folded, shift, out_weight, out_bias, leaky_slope: float = 0.2):
    """The twin of K8. x (B, Cin, H, W) in the compute dtype dt; folded
    (Cin, Cmid, 4, 4) the BN-folded deconv weight in dt; shift (Cmid,) in dt;
    out_weight (Co, Cmid, 4, 4) in dt; out_bias (Co,) float32. Returns
    (B, Co, 2H, 2W) in dt.

    Phase (a, b) of the deconv sums four tap products; each is a float32
    product rounded to dt and added into a dt accumulator as the TPU kernel
    adds them: r = 0 first, then within r = 1 the tap s = 1 first where the
    phase-planar column j = j' + b is even and s = 0 first where it is odd
    (within r = 0 the order cannot change a rounded sum)."""
    dt = x.dtype
    b, cin, h, w = x.shape
    cmid = folded.shape[1]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = folded.float()

    def rnd(t):
        return t.to(dt).float()

    z = torch.empty((b, cmid, 2 * h, 2 * w), dtype=torch.float32, device=x.device)
    for a in (0, 1):
        for bb in (0, 1):
            prod = {}
            for r in (0, 1):
                dy, ky = _tap(a, r)
                for s in (0, 1):
                    dx, kx = _tap(bb, s)
                    xs = xp[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                    prod[r, s] = rnd(torch.einsum("bchw,co->bohw", xs, wf[:, :, ky, kx]))
            y0 = rnd(prod[0, 0] + prod[0, 1])
            s1_first = rnd(rnd(y0 + prod[1, 1]) + prod[1, 0])
            s0_first = rnd(rnd(y0 + prod[1, 0]) + prod[1, 1])
            even = ((torch.arange(w, device=x.device) + bb) % 2 == 0)
            y = torch.where(even, s1_first, s0_first)
            y = rnd(y + shift.float()[:, None, None])
            z[:, :, a::2, bb::2] = rnd(torch.where(y >= 0, y, leaky_slope * y))
    out = F.conv2d(F.pad(z, (1, 2, 1, 2)), out_weight.float()) + out_bias.float()[:, None, None]
    return torch.tanh(out).to(dt)


def _pack_taps(folded: torch.Tensor) -> torch.Tensor:
    """(Cin, Cmid, 4, 4) -> (4, Cin, 4 * Cmid): taps r * 2 + s, columns
    (a * 2 + b) * Cmid + o, from kernel index (3 - a - 2r, 3 - b - 2s): in the
    flipped kernel that is index (2r + a, 2s + b), so one flip and one
    permutation (two copies, few host calls: it runs on every launch)."""
    cin, cmid = folded.shape[:2]
    fl = folded.flip(2, 3).reshape(cin, cmid, 2, 2, 2, 2)  # (ci, o, r, a, s, b)
    return fl.permute(2, 4, 0, 3, 5, 1).reshape(4, cin, 4 * cmid)


# The bf16 kernel's tile (csrc/packed_tail.cu, namespace tc: PR, PC): planar
# rows and columns of one tile, 128 positions, one per wgmma row. A tile
# owns 2 (PR - 2) x 2 (PC - 2) output pixels, from planar row M0 = ty (PR - 2)
# and column J0 = tx (PC - 2); it reads x rows M0 - 1 .. M0 + PR - 1 and
# columns J0 - 1 .. J0 + PC - 1.
TC_PLANAR_TILE = (8, 16)


def tc_tile_grid(h: int, w: int):
    """(tiles_y, tiles_x, output rows, output columns) of one image's tiles
    on the bf16 route, for an (h, w) input and a (2h, 2w) output."""
    pr, pc = TC_PLANAR_TILE
    th, tw = 2 * (pr - 2), 2 * (pc - 2)
    return -(-2 * h // th), -(-2 * w // tw), th, tw


def _pack_tap_tiles(folded: torch.Tensor) -> torch.Tensor:
    """The bf16 route's tap weights: `_pack_taps`' (4, Cin, 4 Cmid) cut into
    (4, ceil(4 Cmid / 64), Cin padded to a multiple of 16, 64) tiles (tap,
    64-column group, input channel, column), zeros in the padding: the wgmma B
    operand, K = Cin deep, 64 columns a group."""
    wpk = _pack_taps(folded)
    _, cin, nc = wpk.shape
    ng, cin_pad = -(-nc // 64), -(-cin // 16) * 16
    if ng * 64 != nc or cin_pad != cin:
        wpk = F.pad(wpk, (0, ng * 64 - nc, 0, cin_pad - cin))
    return wpk.reshape(4, cin_pad, ng, 64).permute(0, 2, 1, 3).contiguous()


# The float32 route's channel order within each group of 8 input channels:
# A fragment lane c of a k8 slice holds channels 2c and 2c + 1 (which puts a
# load's lanes on distinct banks), so K position p of the slice is channel
# TF32_CHANNEL_ORDER[p] (csrc/packed_tail.cu, namespace tf).
TF32_CHANNEL_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _pack_taps_tf32(folded: torch.Tensor) -> torch.Tensor:
    """The float32 route's tap weights: `_pack_taps`' (4, Cin, 4 Cmid) as
    (2, 4, 128, Cin padded to 32), TF32 hi then lo: tap, planar column
    slab * 32 + o (Cmid padded to 32), input channel K-major with each group
    of 8 in TF32_CHANNEL_ORDER; zeros in the padding."""
    wpk = _pack_taps(folded.float())
    _, cin, nc = wpk.shape
    cmid, cin_pad = nc // 4, -(-cin // 32) * 32
    w = F.pad(wpk.reshape(4, cin, 4, cmid), (0, 32 - cmid, 0, 0, 0, cin_pad - cin))
    w = w.permute(0, 2, 3, 1).reshape(4, 128, cin_pad)
    k = torch.arange(cin_pad, device=w.device)  # K position -> channel, made on the device
    perm = k // 8 * 8 + k % 4 * 2 + k % 8 // 4
    return ck.tf32_split(w[..., perm])


def _pack_out_conv_tf32(out_weight: torch.Tensor) -> torch.Tensor:
    """The float32 route's out-conv weights (Co, Cmid, 4, 4) as (2, 16, 4,
    32), TF32 hi then lo: tap dy * 4 + dx, output channel (Co padded to 4),
    input channel (Cmid padded to 32); zeros in the padding."""
    co, cmid = out_weight.shape[:2]
    w = out_weight.float().permute(2, 3, 0, 1).reshape(16, co, cmid)
    return ck.tf32_split(F.pad(w, (0, 32 - cmid, 0, 4 - co)))


def fused_tail(x, folded, shift, out_weight, out_bias, leaky_slope: float = 0.2):
    """K8 on CUDA tensors (arguments as `fused_tail_plain`); the twin on CPU
    tensors."""
    if x.device.type == "cpu":
        return fused_tail_plain(x, folded, shift, out_weight, out_bias, leaky_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tail: unsupported device {x.device}")
    dt = x.dtype
    b, cin, h, w = x.shape
    cmid, co = folded.shape[1], out_weight.shape[0]
    if folded.shape != (cin, cmid, 4, 4) or out_weight.shape != (co, cmid, 4, 4):
        raise ValueError("fused_tail: expected folded (Cin, Cmid, 4, 4) and out_weight (Co, Cmid, 4, 4)")
    if cin > 128 or cmid > 32 or co > 4:
        raise ValueError(f"fused_tail: kernel takes Cin <= 128, Cmid <= 32, Co <= 4; got {cin}, {cmid}, {co}")
    code = ck.dtype_code(dt)
    x = x.contiguous()
    if code == 1:  # the tap tiles, and shift and the out-conv weight in bf16
        taps = _pack_tap_tiles(folded.to(dt))
        shift = shift.to(dt).contiguous()
        wo = out_weight.to(dt).contiguous()
        bias = out_bias.to(torch.float32).contiguous()
    else:  # TF32 hi / lo of the taps and the out-conv weight; shift and bias padded
        taps = _pack_taps_tf32(folded)
        wo = _pack_out_conv_tf32(out_weight)
        shift = F.pad(shift.float(), (0, 32 - cmid))
        bias = F.pad(out_bias.float(), (0, 8 - co))
    ck.require_cuda("fused_tail", x, taps, shift, wo, bias)
    out = torch.empty((b, co, 2 * h, 2 * w), dtype=dt, device=x.device)
    lib = ck.library()
    entry = lib.cic_packed_tail_bf16 if code == 1 else lib.cic_packed_tail
    err = entry(x.data_ptr(), taps.data_ptr(), shift.data_ptr(), wo.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, cin, h, w, cmid, co, float(leaky_slope),
                ck.stream_ptr(x.device))
    ck.check(err, "fused_tail")
    fused_tail.launches += 1
    fused_tail.route_launches["wgmma" if code == 1 else "tf32x3"] += 1
    return out


def int8_tail(x, taps, shift, inv_amax, out_weight, out_bias, leaky_slope: float = 0.2):
    """K8's int8 route on a CUDA bf16 x (B, Cin, H, W): taps from
    `_pack_tap_tiles` of the BN-folded deconv weight, shift (Cmid,) bf16,
    inv_amax (Cmid,) float32 (127 / amax), out_weight (Co, Cmid, 4, 4) bf16
    (scaled by amax / 127), out_bias (Co,) bf16. Returns (B, Co, 2H, 2W) bf16.
    Counted as a K8 launch on route "int8"."""
    bf = torch.bfloat16
    b, cin, h, w = x.shape
    co, cmid = out_weight.shape[:2]
    if x.dtype != bf or out_weight.dtype != bf or shift.dtype != bf or out_bias.dtype != bf:
        raise ValueError("int8_tail: x, shift, out_weight and out_bias must be bfloat16")
    if inv_amax.dtype != torch.float32 or inv_amax.shape != (cmid,):
        raise ValueError("int8_tail: inv_amax must be float32 (Cmid,)")
    if taps.shape != (4, -(-4 * cmid // 64), -(-cin // 16) * 16, 64) or taps.dtype != bf:
        raise ValueError(f"int8_tail: taps {tuple(taps.shape)} do not fit Cin {cin}, Cmid {cmid}")
    if cin > 128 or cmid > 32 or co > 4:
        raise ValueError(f"int8_tail: kernel takes Cin <= 128, Cmid <= 32, Co <= 4; got {cin}, {cmid}, {co}")
    x = x.contiguous()
    ck.require_cuda("int8_tail", x, taps, shift, inv_amax, out_weight, out_bias)
    out = torch.empty((b, co, 2 * h, 2 * w), dtype=bf, device=x.device)
    err = ck.library().cic_packed_tail_int8(
        x.data_ptr(), taps.data_ptr(), shift.data_ptr(), inv_amax.data_ptr(),
        out_weight.data_ptr(), out_bias.data_ptr(), out.data_ptr(), b, cin, h, w, cmid, co,
        float(leaky_slope), ck.stream_ptr(x.device))
    ck.check(err, "int8_tail")
    fused_tail.launches += 1
    fused_tail.route_launches["int8"] += 1
    return out


fused_tail.launches = 0
# launches per route: "wgmma" (bf16), "tf32x3" (float32, three TF32 passes),
# "int8" (`int8_tail`, the serving tail in its int8 form)
fused_tail.route_launches = {"wgmma": 0, "tf32x3": 0, "int8": 0}
