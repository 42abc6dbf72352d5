"""Model FLOPs of the codec, D and VGG19 from a configuration's shapes.

Only the products count (convolutions, transposed convolutions, dense
layers, the attention's two batched products), each at 2 FLOPs a
multiply-add, as `torch.utils.flop_counter.FlopCounterMode` counts them: a
convolution 2 B H' W' Cout Cin k^2 over its output (a transposed one over
its input), a product 2 M K N. A backward costs one forward for the input
gradient where the input depends on a trained leaf, and one for the weight
gradient where the weight is trained. Elementwise work, the mask engine
and the quantizer do not count.

An op is (name, forward FLOPs, weight gradient?, input gradient?).
"""

from __future__ import annotations

import math
from typing import List, Tuple

Op = Tuple[str, float, bool, bool]


def _conv(b, hw_out, cin, cout, k):
    return 2.0 * b * hw_out * hw_out * cin * cout * k * k


def attention_ops(b: int, n: int, c: int, name: str, w_grad: bool) -> List[Op]:
    dk = c // 8
    return [(f"{name}.q", 2.0 * b * n * c * dk, w_grad, True),
            (f"{name}.k", 2.0 * b * n * c * dk, w_grad, True),
            (f"{name}.v", 2.0 * b * n * c * c, w_grad, True),
            (f"{name}.qk", 2.0 * b * n * n * dk, w_grad, True),   # both operands
            (f"{name}.av", 2.0 * b * n * n * c, w_grad, True)]    # take a gradient


def attention_cost(m: dict, b: int, elem_bytes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the HQ encoder's attention block at batch b:
    projections and both products; bytes read once (input, weights,
    biases) and written once (output)."""
    h = m["img_size"][0] // 8
    c = m["encoder_channels"][2]
    n = h * h
    flops = sum(f for _, f, _, _ in attention_ops(b, n, c, "a", False))
    dk = c // 8
    params = 2 * (c * dk + dk) + c * c + c + 1
    return flops, float(elem_bytes) * (2 * b * n * c + params)


def encoder_ops(m: dict, b: int, branch: str, train: bool) -> List[Op]:
    h = m["img_size"][0]
    c1, c2, c3, c4 = m["encoder_channels"]
    d = m["base_latent_dim"] * (2 if branch == "hq" else 1)
    e = f"{branch}_encoder"
    ops = [(f"{e}.conv1", _conv(b, h // 2, m["channels"], c1, 4), train, False),
           (f"{e}.conv2", _conv(b, h // 4, c1, c2, 4), train, train),
           (f"{e}.conv3", _conv(b, h // 8, c2, c3, 4), train, train)]
    if branch == "hq" and m["hq_attention"]:
        ops += attention_ops(b, (h // 8) ** 2, c3, f"{e}.attention", train)
    ops += [(f"{e}.conv4", _conv(b, h // 16, c3, c4, 4), train, train),
            (f"{e}.latent_dense", 2.0 * b * c4 * (h // 16) ** 2 * d, train, train)]
    return ops


def generator_ops(m: dict, b: int, branch: str, train: bool) -> List[Op]:
    c1, c2, c3, _ = m["encoder_channels"]
    g = m["generator_channels"]
    d = m["base_latent_dim"] * (2 if branch == "hq" else 1)
    base, hw = m["generator_base_ch"], m["generator_base_hw"]
    name = f"{branch}_generator"
    ops = [(f"{name}.fc", 2.0 * b * d * base * hw * hw, train, train)]
    cin = base
    for i, (ch, skip) in enumerate(zip(g, (c3, c2, c1, 0)), start=1):
        side = hw << (i - 1)
        ops.append((f"{name}.deconv{i}", 2.0 * b * side * side * cin * ch * 16, train, train))
        cin = ch + skip
    ops.append((f"{name}.out_conv", _conv(b, hw * 16, g[3], m["channels"], 4), train, train))
    return ops


def saliency_ops(m: dict, b: int, branch: str, w_grad: bool, x_grad: bool) -> List[Op]:
    d = m["base_latent_dim"] * (2 if branch == "hq" else 1)
    s = f"latent_saliency_{branch}"
    return [(f"{s}.dense1", 2.0 * b * d * 512, w_grad, x_grad),
            (f"{s}.dense2", 2.0 * b * 512 * 256, w_grad, True),
            (f"{s}.out", 2.0 * b * 256, w_grad, True)]


def rd_ops(m: dict, b: int, train: bool) -> List[Op]:
    h = m["img_size"][0]
    return [("rd.conv1", _conv(b, h // 2, 1, 32, 3), train, False),
            ("rd.conv2", _conv(b, h // 4, 32, 64, 3), train, train),
            ("rd.dense", 2.0 * b * 65 * 128, train, train),
            ("rd.base_params", 2.0 * b * 128 * 3, train, train)]


def serve_ops(m: dict, b: int) -> List[Op]:
    """The served forward: both encoders, the saliency nets, the RD net
    (computed on the served path), both generators."""
    ops: List[Op] = []
    for br in ("hq", "lq"):
        ops += encoder_ops(m, b, br, False) + saliency_ops(m, b, br, False, False)
        ops += generator_ops(m, b, br, False)
    return ops + rd_ops(m, b, False)


def disc_ops(m: dict, b: int, w_grad: bool, first_x_grad: bool) -> List[Op]:
    h = m["img_size"][0]
    stages = min(max(1, int(math.log2(h / 4))), m["disc_max_stages"])
    ops, f, cin = [], m["disc_base_filters"], m["channels"]
    for i in range(stages):
        ops.append((f"disc.conv{i}", _conv(b, h >> (i + 1), cin, f, 4), w_grad,
                    first_x_grad or i > 0))
        cin, f = f, min(f * 2, m["disc_max_filters"])
    hw = h >> stages
    units = m["disc_dense_units"]
    return ops + [("disc.dense", 2.0 * b * cin * hw * hw * units, w_grad, True),
                  ("disc.out", 2.0 * b * units, w_grad, True)]


VGG19_LAYOUT = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


def vgg_ops(m: dict, b: int, x_grad: bool) -> List[Op]:
    h = m["img_size"][0]
    ops, cin = [], 3
    for bi, (width, n) in enumerate(VGG19_LAYOUT):
        for ci in range(n):
            ops.append((f"vgg.{bi}.{ci}", _conv(b, h >> bi, cin, width, 3), False, x_grad))
            cin = width
    return ops


def train_ops(m: dict, b: int, do_d: bool, use_perceptual: bool) -> List[Op]:
    """One training step: the codec's forward and backward, D's phase
    (when do_d) on the real and the detached fake images, the G phase's
    pass through the updated D, VGG19 on both images and its input
    gradient."""
    ops: List[Op] = []
    for br in ("hq", "lq"):
        ops += encoder_ops(m, b, br, True)
        ops += saliency_ops(m, b, br, False, True)   # the quantizer's score, frozen nets
        ops += saliency_ops(m, b, br, True, False)   # the LS loss's score, detached latent
        ops += generator_ops(m, b, br, True)
    ops += rd_ops(m, b, True)
    if do_d:
        ops += disc_ops(m, b, True, False) + disc_ops(m, b, True, False)
    ops += disc_ops(m, b, False, True)
    if use_perceptual:
        ops += vgg_ops(m, b, False) + vgg_ops(m, b, True)
    return ops


def total(ops: List[Op], backward: bool) -> float:
    return sum(f * (1 + (backward and w) + (backward and x)) for _, f, w, x in ops)
