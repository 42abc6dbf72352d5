"""K8: the generator's fused inference tail, and its plain PyTorch twin.

K8 replaces `contextual_image_compression_tpu/models/packed_tail.py::
fused_tail_pallas`, which `packed_tail_forward(use_pallas=True)` reaches:
BN-folded 4x4/s2 transposed conv -> + shift -> LeakyReLU -> zeros outside
the image -> 4x4/s1 SAME conv -> + bias -> tanh, in NCHW. `fused_tail`
launches the kernel in `csrc/packed_tail.cu` for CUDA tensors and runs the
twin `fused_tail_plain` for CPU tensors. The twin keeps the TPU kernel's
roundings: each of the four polyphase tap products rounded to the compute
dtype and added into a dtype accumulator in the kernel's order, LeakyReLU in
float32, the out-conv in float32. Inference only (no backward), as in JAX.
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
    (a * 2 + b) * Cmid + o, from kernel index (3 - a - 2r, 3 - b - 2s)."""
    taps = []
    for r in (0, 1):
        for s in (0, 1):
            cols = [folded[:, :, _tap(a, r)[1], _tap(bb, s)[1]] for a in (0, 1) for bb in (0, 1)]
            taps.append(torch.cat(cols, dim=1))
    return torch.stack(taps).contiguous()


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
    x = x.contiguous()
    wpk = _pack_taps(folded.to(dt))
    shift = shift.to(dt).contiguous()
    wo = out_weight.to(dt).contiguous()
    bias = out_bias.to(torch.float32).contiguous()
    ck.require_cuda("fused_tail", x, wpk, shift, wo, bias)
    out = torch.empty((b, co, 2 * h, 2 * w), dtype=dt, device=x.device)
    err = ck.library().cic_packed_tail(
        ck.dtype_code(dt), x.data_ptr(), wpk.data_ptr(), shift.data_ptr(), wo.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, cin, h, w, cmid, co, float(leaky_slope),
        ck.stream_ptr(x.device),
    )
    ck.check(err, "fused_tail")
    fused_tail.launches += 1
    return out


fused_tail.launches = 0
