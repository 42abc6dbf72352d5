"""Layer building blocks with the numerics of the JAX package's Keras-style layers.

Counterpart of `contextual_image_compression_tpu/models/layers.py`. Modules
run in NCHW and hold weights in PyTorch layouts (conv OIHW, transposed conv
(Cin, Cout, kh, kw), dense (out, in)); `convert.py` carries JAX variables
over. Each layer computes in its compute dtype and rounds where the flax
layer rounds: convolution and dense products round before the bias is added,
BatchNorm computes in the promoted dtype of its input, statistics and
parameters and rounds once, and scalar constants take the compute dtype
first (JAX's weakly typed Python scalars), so bfloat16 serving follows the
JAX graph op by op. Parameters may stay float32 under a bfloat16 input (mixed
precision): each layer casts them to the compute dtype at use, and the
cast's backward carries the gradient to the float32 parameter.

flax's SAME padding is asymmetric for even kernels: k4/s1 pads (1, 2), k4/s2
pads (1, 1) and k3/s2 pads (0, 1) on each spatial axis.

On a mesh (parallel/sharding.py), a parameter split over the model axis is
gathered where it is used (`used`), and KBatchNorm's batch statistics are
taken over the global batch; the codec's latent / fc projections compute
over the model group (`KDense.tensor_parallel`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.ops.image_ops import true_div
from contextual_image_compression_tpu_torch.utils.tree import cast_floats  # noqa: F401 (re-export)


@functools.lru_cache(maxsize=256)
def const(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim constant in `dtype` on `device`, made once: multiplying by it
    rounds the constant to the tensor's dtype first, as JAX does with a
    Python scalar."""
    return torch.full((), value, dtype=dtype, device=device)


def used(module: nn.Module, name: str) -> torch.Tensor:
    """Parameter `name` of `module` whole: a slice split over the model
    axis (parallel/sharding.py) is gathered, its gradient going back to the
    slice."""
    t = getattr(module, name)
    shard = getattr(module, "_shards", {}).get(name)
    return t if shard is None else shard.gather(t)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * const(slope, x.dtype, x.device))


def same_pads(size: int, kernel: int, stride: int):
    """flax/XLA SAME padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator):
    """Glorot-uniform values drawn in float32 and rounded to t's dtype. (JAX
    draws a bf16 parameter in bf16 directly, so a bf16 init has the same
    distribution and other numbers; tests carry JAX's weights across.)"""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        t.copy_(draw.uniform_(-limit, limit, generator=gen))
    return t


class KConv(nn.Module):
    """Conv2D with SAME padding; weight (O, I, k, k)."""

    def __init__(self, cin: int, features: int, kernel: int = 4, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.zeros(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator):
        k, cin, cout = self.kernel, self.weight.shape[1], self.weight.shape[0]
        glorot_uniform_(self.weight, k * k * cin, k * k * cout, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(x.shape[-2], self.kernel, self.stride)
        pw = same_pads(x.shape[-1], self.kernel, self.stride)
        w = used(self, "weight").to(x.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        else:
            y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=self.stride)
        return y + used(self, "bias").to(x.dtype)[:, None, None]


class KConvT(nn.Module):
    """ConvTranspose 4x4/s2 SAME; weight (Cin, Cout, 4, 4), flipped from flax.

    polyphase=True lowers it as the JAX package's `_PolyphaseConvT4x4s2`
    does: one stride-1 2x2 convolution with 4 * Cout outputs over the
    1-padded input, each output phase (a, b) taking kernel rows and columns
    {a, a + 2} x {b, b + 2}, then the four phases interleaved. Same function
    (to float32 noise), same parameters, so checkpoints are interchangeable."""

    def __init__(self, cin: int, features: int, kernel: int = 4, stride: int = 2,
                 polyphase: bool = False):
        super().__init__()
        if (kernel, stride) != (4, 2):
            raise ValueError("KConvT supports the codec's 4x4 stride-2 SAME deconv only")
        self.polyphase = polyphase
        self.weight = nn.Parameter(torch.zeros(cin, features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator):
        cin, cout = self.weight.shape[:2]
        glorot_uniform_(self.weight, 16 * cout, 16 * cin, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = used(self, "weight").to(x.dtype)
        if self.polyphase:
            y = _polyphase_deconv(x, w)
        else:
            y = F.conv_transpose2d(x, w, stride=2, padding=1)
        return y + used(self, "bias").to(x.dtype)[:, None, None]


def _polyphase_deconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 4x4/s2 SAME transposed convolution of x (B, Cin, H, W) by the
    port's weight w (Cin, Cout, 4, 4) as four phase convolutions in one."""
    b, _, h, wd = x.shape
    cout = w.shape[1]
    k = w.permute(2, 3, 0, 1).flip(0, 1)  # flax's (4, 4, Cin, Cout)
    taps = ((0, 2), (1, 3))
    subs = [k[list(taps[a])][:, list(taps[c])] for a in (0, 1) for c in (0, 1)]
    wbig = torch.cat(subs, dim=-1).permute(3, 2, 0, 1)  # (4 Cout, Cin, 2, 2)
    yall = F.conv2d(F.pad(x, (1, 1, 1, 1)), wbig)  # (B, 4 Cout, H + 1, W + 1)
    phases = [yall[:, i * cout:(i + 1) * cout, a:h + a, c:wd + c]
              for i, (a, c) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    ph = torch.stack(phases, dim=-1).reshape(b, cout, h, wd, 2, 2)
    return ph.permute(0, 1, 2, 4, 3, 5).reshape(b, cout, 2 * h, 2 * wd)


class PolyphaseConvT4x4s2(KConvT):
    """The JAX package's `_PolyphaseConvT4x4s2`: `KConvT(polyphase=True)`."""

    def __init__(self, cin: int, features: int):
        super().__init__(cin, features, polyphase=True)


class KDense(nn.Module):
    """Dense layer; weight (out, in).

    w8=True is the weight-only int8 form y = x @ (q * s).T + b, at inference
    only (train=True takes the float path, as the JAX codec builds the
    layer with `w8=dense_w8 and not train`). Serving installs a per-output
    int8 row `weight_q` and its float32 scale `w8_scale` (out, 1) with
    `prepare_w8`: from the float32 weight for the giant projections
    (`quantize_dense_w8`), from the compute-dtype weight for the rest. A
    layer that still holds its float weight quantizes it at every call, as
    the JAX layer does at trace time: s = max|w| / 127 per output, q =
    rint(w / max(s, 1e-12)) cast to int8, so a gradient reaches the weight
    through s alone (the arg-max entries of each row, ties sharing it).

    int8=True is the W8A8 form (`dense_int8`), at inference only: a forward
    with train=True takes the float path, as the JAX codec builds the layer
    with `int8=dense_int8 and not train`. w8 wins over int8, as in the JAX
    layer.

    tensor_parallel=True (the codec's latent and fc projections): on a mesh
    that splits the float weight, the product runs over the model group,
    row-parallel when the inputs are split (each rank multiplies its slice
    of x by its rows, the partial products are summed in float32 and the
    bias is added once) and column-parallel when the outputs are (the
    slices' outputs are gathered). Otherwise a split weight is gathered at
    use, w8 and int8 forms included."""

    def __init__(self, cin: int, features: int, w8: bool = False, int8: bool = False,
                 tensor_parallel: bool = False):
        super().__init__()
        self.w8, self.int8 = w8, int8
        self.tensor_parallel = tensor_parallel
        self.weight = nn.Parameter(torch.zeros(features, cin))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("weight_q", None)
        self.register_buffer("w8_scale", None)

    def reset_parameters(self, gen: torch.Generator):
        glorot_uniform_(self.weight, self.weight.shape[1], self.weight.shape[0], gen)
        nn.init.zeros_(self.bias)

    def set_w8(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Install int8 rows and their float32 scales; the float weight goes."""
        self.weight_q = q.to(torch.int8)
        self.w8_scale = scale.to(torch.float32).reshape(-1, 1)
        self.weight = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cd = x.dtype
        if self.w8 and not train:
            if self.weight_q is not None:
                w = self.weight_q.to(cd) * self.w8_scale.to(cd)
            else:
                q, s = w8_quantize(used(self, "weight"))
                w = q.to(cd) * s.to(cd)
        else:
            if self.weight is None:
                raise TypeError("KDense holds int8 rows only (prepare_w8): its float path "
                                "(train=True, or w8=False) has no weight")
            if self.int8 and not train:
                return dense_w8a8(x, used(self, "weight"), used(self, "bias"))
            shard = getattr(self, "_shards", {}).get("weight")
            if shard is not None and self.tensor_parallel:
                return self._tensor_parallel(x, shard)
            w = used(self, "weight").to(cd)
        return F.linear(x, w) + used(self, "bias").to(cd)

    def _tensor_parallel(self, x: torch.Tensor, shard) -> torch.Tensor:
        from contextual_image_compression_tpu_torch.parallel import collectives as C

        cd, g = x.dtype, shard.group
        x = C.copy_to(x, g)
        w = self.weight.to(cd)
        if shard.dim == 1:  # inputs split: row-parallel
            xs = x.chunk(g.size, -1)[g.index]
            y = C.sum_replicated(F.linear(xs, w).float(), g).to(cd)
        else:               # outputs split: column-parallel
            y = C.gather_replicated(F.linear(x, w), g, -1)
        return y + used(self, "bias").to(cd)


def _symmetric_int8(x32: torch.Tensor, dim: int):
    """(rint(x / s), s) with s = max|x| / 127 along `dim`, floored at 1e-12
    in the division only, all in float32 (the JAX layer's quantizer; IEEE
    divisions on the card too)."""
    s = true_div(torch.amax(torch.abs(x32), dim=dim, keepdim=True), 127.0)
    return torch.round(x32 / torch.clamp(s, min=1e-12)).to(torch.int8), s


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32, exact (int32
    accumulation). On the card this is cuBLAS through `torch._int_mm`, which
    takes M > 16 and K, N multiples of 8: zero rows and columns pad the
    operands up to that (exact) and are cut from the result. On the CPU an
    int32 product."""
    if a.device.type != "cuda":
        return torch.mm(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def dense_w8a8(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The JAX layer's W8A8 dense (`KDense(int8=True)`): the weight (out, in)
    per output and x (..., in) per row quantized to int8 symmetrically in
    float32, the int32 product, then acc * sx * sw + b in float32, rounded to
    x's dtype."""
    qw, sw = _symmetric_int8(weight.float(), dim=1)  # (out, in), (out, 1)
    x2 = x.reshape(-1, x.shape[-1]).float()
    qx, sx = _symmetric_int8(x2, dim=1)              # (M, in), (M, 1)
    acc = int8_matmul(qx, qw.t())
    y = acc.float() * sx * sw.t() + bias.float()
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def w8_quantize(weight: torch.Tensor):
    """Symmetric per-output-row int8: s = max|w|_row / 127, q = rint(w / s)."""
    w32 = weight.to(torch.float32)
    s = torch.amax(torch.abs(w32), dim=1, keepdim=True) / 127.0
    q = torch.round(w32 / torch.clamp(s, min=1e-12)).to(torch.int8)
    return q, s


def quantize_dense_w8(model: nn.Module, min_elems: int = 1 << 23) -> int:
    """Quantize, in place and from their float32 weights, the w8 dense layers
    holding at least `min_elems` weights (the codec's latent/fc projections).
    Call before any cast to bfloat16. Returns how many layers it converted."""
    n = 0
    for mod in model.modules():
        if isinstance(mod, KDense) and mod.w8 and mod.weight is not None:
            if mod.weight.numel() >= min_elems:
                mod.set_w8(*w8_quantize(mod.weight.detach().to(torch.float32)))
                n += 1
    return n


def prepare_w8(model: nn.Module) -> None:
    """Quantize the remaining w8 dense layers from their current (compute
    dtype) weights, as the JAX layer does at trace time for kernels below
    the `quantize_dense_w8` threshold."""
    for mod in model.modules():
        if isinstance(mod, KDense) and mod.w8 and mod.weight is not None:
            mod.set_w8(*w8_quantize(mod.weight.detach()))


class KBatchNorm(nn.Module):
    """BatchNorm over (N, C, H, W) with flax's numerics (eps 1e-3, momentum
    0.99), step by step: y = x - mean; mul = rsqrt(var + eps) * scale;
    y = y * mul + bias, each step in the promoted dtype of its operands, and
    the result rounded once to x's dtype, as flax's `_normalize` does. So
    bfloat16 serving, whose statistics, scale and bias are cast to bfloat16,
    rounds after every step, and mixed precision (bfloat16 x, float32
    statistics and parameters) computes in float32 and rounds at the end.

    train=False uses the running statistics. train=True uses the batch mean
    and the biased batch variance max(E[x^2] - E[x]^2, 0), computed in float32
    over N, H and W whatever x's dtype (flax's fast variance; `F.batch_norm`
    would update the running variance with the unbiased one). The running
    update running = 0.99 * running + 0.01 * batch is not applied in the
    forward: the batch statistics wait in `pending` until
    `commit_batch_stats()`, so the caller decides which forward's statistics
    count.

    On a mesh (`mesh`, set by parallel/sharding.py's shard_state) with more
    than one data index, train=True takes the float32 sums of x and x^2 and
    the count over the global batch (all-reduced over the data group, with
    their gradient), so `pending` holds the global statistics, as the JAX
    layer computes them under SPMD."""

    momentum = 0.99

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(features))  # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.pending = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            x32 = x.float()
            group = self.mesh.data_parallel_group() if self.mesh is not None else None
            if group is None:
                mean = x32.mean(dim=(0, 2, 3))
                var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            else:
                from contextual_image_compression_tpu_torch.parallel import collectives as C

                n = x32.numel() // x32.shape[1] * group.size
                sums = C.sum_shared(torch.stack([x32.sum(dim=(0, 2, 3)),
                                                 (x32 * x32).sum(dim=(0, 2, 3))]), group)
                mean = sums[0] / n
                var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            self.pending = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        y = x - mean[:, None, None]
        mul = torch.rsqrt(var + const(self.eps, var.dtype, var.device)) * self.weight
        y = y * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)

    @torch.no_grad()
    def commit_batch_stats(self) -> None:
        """Fold the last train-mode forward's batch statistics into the
        running ones (no-op when there are none)."""
        if self.pending is None:
            return
        mean, var = self.pending
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.pending = None


def commit_batch_stats(module: nn.Module) -> None:
    """Commit the pending batch statistics of every KBatchNorm in `module`."""
    for mod in module.modules():
        if isinstance(mod, KBatchNorm):
            mod.commit_batch_stats()
