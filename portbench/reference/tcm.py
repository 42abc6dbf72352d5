"""TCM (arXiv:2303.14978, jmliu206/LIC_TCM `models/tcm.py` on CompressAI's
layers, SCUNet's windowed attention) in plain PyTorch, on a dict of tensors
named as the program's state dict. It imports nothing of the program and
nothing of JAX.

Layers (NCHW between blocks; conv weights (O, I, k, k), linears (out, in)):

  g_a: RBS(3, 2N); CTB W, SW (hd 8); RBS; CTB x2 (16); RBS; CTB x2 (32);
       conv3x3(2N, M, 2) -> y
  g_s: RBU(M, 2N); CTB x2 (32); RBU; CTB x2 (16); RBU; CTB x2 (8);
       subpel(2N, 3, 2) -> x_hat
  h_a: RBS(M, 2N); CTB x2 (32, window 4); conv3x3(2N, 192, 2) -> z
  h_mean_s, h_scale_s: RBU(192, 2N); CTB x2 (32, window 4); subpel(2N, M, 2)
  slices: y in 5 slices; S_i = cat(bar, y_hat_<i); m_i = SWAtten_i(S_i);
       mu_i = cc_i(m_i), sigma_i = max(cc'_i(m'_i), 0.11); s_i =
       round(y_i - mu_i); y_hat_i = s_i + mu_i + 0.5 tanh(LRP_i(cat(m_i,
       s_i + mu_i)))

A k x k convolution pads k // 2 with zeros on each side (PyTorch's). RBS(x)
= GDN(conv2(LReLU(conv1_s2(x)))) + skip_s2(x); RBU(x) =
IGDN(conv(LReLU(subpel(x)))) + subpel'(x); subpel: conv3x3 to r^2 times
the channels, then depth to space (channel c r^2 + i r + j to row i,
column j of each 2 x 2 cell), written out here; LReLU slope 0.01. GDN:
x / sqrt(beta + gamma x^2) with beta = max(b, sqrt(1e-6 + p))^2 - p, gamma
= max(g, sqrt(p))^2 - p, p = 2^-36 (IGDN multiplies). CTB: conv1x1, split,
c + RB(c) with RB(x) = x + LReLU(conv(LReLU(conv(x)))), the Swin Block on
t, conv1x1 of the concatenation added to x. Block: x + WMSA(LN(x)), then
x + Linear(GELU(Linear(LN(x)))), LN eps 1e-5.

WMSA, per image, written from the token coordinates: the shifted type
reads the image at ((r + w / 2) mod H, (c + w / 2) mod W) for rolled
position (r, c) and writes its output back there. Tokens go in raster
order of their window, (r // w, c // w), and then of their place in it; a
chunk of CHUNK_WINDOWS consecutive windows (fewer where the windows do not
divide by it) is attended as one dense set of tokens, where a pair may
attend only if both tokens lie in the same window and, for the shifted
type, in the same region of the rolled image (rows
at or past H - w / 2 one region, the rest another; columns likewise). The
score of a pair is q . k / sqrt(hd) plus the head's bias at (r_q - r_k +
w - 1, c_q - c_k + w - 1). Heads: q, k, v are the first, second and last
d channels of the Linear(d, 3d), head h their channels [h hd, (h + 1) hd).

SWAtten(c): u = conv1x1(c, 128); z = Block SW of Block W of u (hd 16,
w 8); conv1x1(128, c)(A(u) sigmoid(B(z)) + u), A three residual units,
B three and a conv1x1; a unit: ReLU(x + conv1x1(ReLU(conv3x3(ReLU(
conv1x1(x)))))). cc and LRP: conv3x3 to 224, GELU, to 128, GELU, to M / 5.

Rounding (`rnd`, precision.Rounding): `operands` where the program holds a
value in its compute dtype before a product (the inputs, weights and
biases of every convolution and linear, LN's scale and shift, GDN's x^2 and
gamma, the attention's probabilities before the product with v, z_hat and
y_hat as the syntheses take them, the image), `results` where it stores a
value (each convolution's product and then its sum with the bias, each
linear's output, LN's, GDN's, the activations', every residual sum and
product, the attention's output). FLOAT32 computes everything in float32.
The attention's relative-position bias is added in float32 under every
rounding, the precision the configuration states for it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.hific import std_cumulative, z_likelihood
from portbench.reference.precision import FLOAT32

Params = Dict[str, torch.Tensor]
PEDESTAL = 2.0 ** -36
CHUNK_WINDOWS = 4
SCORE_ELEMENTS = 1 << 27  # float32 scores held at once in the attention


# ---- shapes -------------------------------------------------------------

def _stages(m: dict) -> Tuple[list, list]:
    """g_a's and g_s's layers as (kind, args) in their order of index."""
    n, mm, w, hd, blocks = m["n"], m["m"], m["window"], m["head_dims"], m["stage_blocks"]
    def ctbs(stage):  # W, SW, W, ...
        return [("ctb", (n, hd[stage], w, i % 2 == 1)) for i in range(blocks[stage])]

    g_a = [("rbs", (m["channels"], 2 * n))] + ctbs(0)
    g_a += [("rbs", (2 * n, 2 * n))] + ctbs(1) + [("rbs", (2 * n, 2 * n))] + ctbs(2)
    g_a += [("conv_s2", (2 * n, mm))]
    g_s = [("rbu", (mm, 2 * n))] + ctbs(3) + [("rbu", (2 * n, 2 * n))] + ctbs(4)
    g_s += [("rbu", (2 * n, 2 * n))] + ctbs(5) + [("subpel", (2 * n, m["channels"]))]
    return g_a, g_s


def _hyper(m: dict) -> Tuple[list, list]:
    n, hw, hd, blocks = m["n"], m["hyper_window"], m["hyper_head_dim"], m["stage_blocks"]
    h_a = [("rbs", (m["m"], 2 * n))] + [("ctb", (n, hd, hw, i % 2 == 1))
                                          for i in range(blocks[0])]
    h_a += [("conv_s2", (2 * n, m["z_channels"]))]
    h_s = [("rbu", (m["z_channels"], 2 * n))] + [("ctb", (n, hd, hw, i % 2 == 1))
                                                  for i in range(blocks[3])]
    h_s += [("subpel", (2 * n, m["m"]))]
    return h_a, h_s


def _support(m: dict) -> Tuple[List[int], List[int]]:
    """Input widths of each slice's SWAtten / cc and of its LRP."""
    k, mm, sup = m["num_slices"], m["m"], m["max_support_slices"]
    sl = mm // k
    return ([mm + sl * min(i, sup) for i in range(k)],
            [mm + sl * min(i + 1, sup + 1) for i in range(k)])


def shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter by name, from the configuration's model block."""
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    def linear(name, cin, cout):
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)

    def gdn(name, c):
        out[f"{name}.beta"] = (c,)
        out[f"{name}.gamma"] = (c, c)

    def block(name, d, hd, w):
        out[f"{name}.ln1.weight"] = out[f"{name}.ln1.bias"] = (d,)
        linear(f"{name}.msa.embedding_layer", d, 3 * d)
        out[f"{name}.msa.relative_position_params"] = (d // hd, 2 * w - 1, 2 * w - 1)
        linear(f"{name}.msa.linear", d, d)
        out[f"{name}.ln2.weight"] = out[f"{name}.ln2.bias"] = (d,)
        linear(f"{name}.mlp.0", d, 4 * d)
        linear(f"{name}.mlp.2", 4 * d, d)

    def layer(name, kind, args):
        if kind == "rbs":
            a, b = args
            conv(f"{name}.conv1", a, b, 3)
            conv(f"{name}.conv2", b, b, 3)
            gdn(f"{name}.gdn", b)
            conv(f"{name}.skip", a, b, 1)
        elif kind == "rbu":
            a, b = args
            conv(f"{name}.subpel_conv.0", a, 4 * b, 3)
            conv(f"{name}.conv", b, b, 3)
            gdn(f"{name}.igdn", b)
            conv(f"{name}.upsample.0", a, 4 * b, 3)
        elif kind == "ctb":
            n, hd, w, _ = args
            conv(f"{name}.conv1_1", 2 * n, 2 * n, 1)
            conv(f"{name}.conv1_2", 2 * n, 2 * n, 1)
            conv(f"{name}.conv_block.conv1", n, n, 3)
            conv(f"{name}.conv_block.conv2", n, n, 3)
            block(f"{name}.trans_block", n, hd, w)
        elif kind == "conv_s2":
            conv(name, args[0], args[1], 3)
        else:  # subpel
            conv(f"{name}.0", args[0], 4 * args[1], 3)

    g_a, g_s = _stages(m)
    h_a, h_s = _hyper(m)
    for prefix, layers in (("g_a", g_a), ("g_s", g_s), ("h_a", h_a), ("h_mean_s", h_s),
                           ("h_scale_s", h_s)):
        for i, (kind, args) in enumerate(layers):
            layer(f"{prefix}.{i}", kind, args)
    att, lrp = _support(m)
    d, sl = m["swatten_dim"], m["m"] // m["num_slices"]
    widths = list(m["cc_widths"])
    for side in ("mean", "scale"):
        for i, c in enumerate(att):
            a = f"atten_{side}.{i}.0"
            conv(f"{a}.in_conv", c, d, 1)
            block(f"{a}.non_local_block.block_1", d, m["swatten_head_dim"], m["window"])
            block(f"{a}.non_local_block.block_2", d, m["swatten_head_dim"], m["window"])
            for branch, units in (("conv_a", 3), ("conv_b", 3)):
                for u in range(units):
                    conv(f"{a}.{branch}.{u}.conv.0", d, d // 2, 1)
                    conv(f"{a}.{branch}.{u}.conv.2", d // 2, d // 2, 3)
                    conv(f"{a}.{branch}.{u}.conv.4", d // 2, d, 1)
            conv(f"{a}.conv_b.3", d, d, 1)
            conv(f"{a}.out_conv", d, c, 1)
    for name, cins in (("cc_mean_transforms", att), ("cc_scale_transforms", att),
                       ("lrp_transforms", lrp)):
        for i, c in enumerate(cins):
            dims = [c] + widths + [sl]
            for j, (a, b) in enumerate(zip(dims, dims[1:])):
                conv(f"{name}.{i}.{2 * j}", a, b, 3)
    dims = [1] + list(m["factorized_filters"]) + [1]
    zc = m["z_channels"]
    for k in range(len(dims) - 1):
        out[f"entropy_bottleneck.matrix{k}"] = (zc, dims[k + 1], dims[k])
        out[f"entropy_bottleneck.bias{k}"] = (zc, dims[k + 1], 1)
        if k < len(dims) - 2:
            out[f"entropy_bottleneck.factor{k}"] = (zc, dims[k + 1], 1)
    out["entropy_bottleneck.offset"] = (zc,)
    return out


# ---- layers ----------------------------------------------------------------

def conv(p: Params, name: str, x, stride: int = 1, rnd=FLOAT32):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    y = F.conv2d(F.pad(rnd.operands(x), (k // 2,) * 4), rnd.operands(w), stride=stride)
    return rnd.results(rnd.results(y) + rnd.operands(p[f"{name}.bias"])[:, None, None])


def linear(p: Params, name: str, x, rnd=FLOAT32):
    y = rnd.operands(x) @ rnd.operands(p[f"{name}.weight"]).T
    return rnd.results(y + rnd.operands(p[f"{name}.bias"]))


def lrelu(x, rnd):
    return rnd.results(torch.where(x >= 0, x, x * 0.01))


def gelu(x, rnd):
    return rnd.results(0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))


def depth_to_space(x, r: int = 2):
    """(B, C r^2, H, W) -> (B, C, H r, W r): channel c r^2 + i r + j to
    offset (i, j) of each r x r cell."""
    b, c4, h, w = x.shape
    c = c4 // (r * r)
    out = x.new_empty((b, c, h * r, w * r))
    for i in range(r):
        for j in range(r):
            out[:, :, i::r, j::r] = x[:, (i * r + j)::(r * r)]
    return out


def subpel(p: Params, name: str, x, rnd=FLOAT32):
    return depth_to_space(conv(p, f"{name}.0", x, 1, rnd))


def gdn(p: Params, name: str, x, inverse: bool, rnd=FLOAT32):
    beta = torch.clamp(p[f"{name}.beta"].float(), min=math.sqrt(1e-6 + PEDESTAL)) ** 2 - PEDESTAL
    gamma = torch.clamp(p[f"{name}.gamma"].float(), min=math.sqrt(PEDESTAL)) ** 2 - PEDESTAL
    pool = rnd.results(torch.einsum("ij,bjhw->bihw", rnd.operands(gamma), rnd.operands(x * x)))
    pool = pool + beta[:, None, None]
    return rnd.results(x * (torch.sqrt(pool) if inverse else 1.0 / torch.sqrt(pool)))


def layer_norm(p: Params, name: str, x, rnd=FLOAT32):
    """Over the last axis, eps 1e-5, the biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + 1e-5)
    return rnd.results(y * rnd.operands(p[f"{name}.weight"]) + rnd.operands(p[f"{name}.bias"]))


def _window_order(h: int, w: int, win: int, device):
    """Flat token indices (r W + c) of an h x w grid in raster order of
    their window, then of their place in it; and each token's (r, c)."""
    wi = torch.arange((h // win) * (w // win), device=device)
    place = torch.arange(win * win, device=device)
    r = (wi // (w // win))[:, None] * win + (place // win)[None, :]
    c = (wi % (w // win))[:, None] * win + (place % win)[None, :]
    return (r * w + c).reshape(-1), r.reshape(-1), c.reshape(-1)


def wmsa(p: Params, name: str, x, head_dim: int, win: int, shifted: bool, rnd=FLOAT32):
    """x (B, H, W, d) -> the attention's output projected, (B, H, W, d)."""
    b, h, w, d = x.shape
    heads = d // head_dim
    s = win // 2 if shifted else 0
    rows = (torch.arange(h, device=x.device) + s) % h  # rolled position -> source
    cols = (torch.arange(w, device=x.device) + s) % w
    order, r, c = _window_order(h, w, win, x.device)
    src = (rows[r] * w + cols[c])  # the image token each rolled token reads
    # the bias stays float32 under every rounding (the configuration's
    # precision), so a program that rounds it is measured, not copied
    table = p[f"{name}.relative_position_params"].float()
    windows = (h // win) * (w // win)
    per_chunk = CHUNK_WINDOWS
    while windows % per_chunk:
        per_chunk //= 2
    chunk = per_chunk * win * win
    per_group = max(1, SCORE_ELEMENTS // (heads * chunk * chunk))
    out = torch.empty_like(x).reshape(b, h * w, d)
    for i in range(b):
        qkv = linear(p, f"{name}.embedding_layer", x[i].reshape(h * w, d)[src], rnd)
        q, k, v = (t.reshape(-1, chunk, heads, head_dim).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        n_chunks = q.shape[0]
        rc = r.reshape(n_chunks, chunk)
        cc = c.reshape(n_chunks, chunk)
        o = torch.empty_like(q)
        for g0 in range(0, n_chunks, per_group):
            g = slice(g0, g0 + per_group)
            rq, cq = rc[g][:, :, None], cc[g][:, :, None]
            rk, ck = rc[g][:, None, :], cc[g][:, None, :]
            allowed = (rq // win == rk // win) & (cq // win == ck // win)
            if shifted:
                allowed &= ((rq >= h - s) == (rk >= h - s)) & ((cq >= w - s) == (ck >= w - s))
            dy = torch.clamp(rq - rk + win - 1, 0, 2 * win - 2)
            dx = torch.clamp(cq - ck + win - 1, 0, 2 * win - 2)
            bias = table[:, dy, dx].transpose(0, 1)  # (chunks, heads, chunk, chunk)
            scores = (q[g] @ k[g].transpose(-1, -2)) / math.sqrt(head_dim) + bias
            scores = scores.masked_fill(~allowed[:, None], -math.inf)
            probs = torch.softmax(scores, dim=-1)
            o[g] = rnd.results(rnd.operands(probs) @ v[g])
        merged = o.transpose(1, 2).reshape(-1, d)
        out[i, src] = linear(p, f"{name}.linear", merged, rnd)
    return out.reshape(b, h, w, d)


def block(p: Params, name: str, x, head_dim: int, win: int, shifted: bool, rnd=FLOAT32):
    """SCUNet's Block on (B, H, W, d)."""
    x = rnd.results(x + wmsa(p, f"{name}.msa", layer_norm(p, f"{name}.ln1", x, rnd),
                             head_dim, win, shifted, rnd))
    hidden = gelu(linear(p, f"{name}.mlp.0", layer_norm(p, f"{name}.ln2", x, rnd), rnd), rnd)
    return rnd.results(x + linear(p, f"{name}.mlp.2", hidden, rnd))


def ctb(p: Params, name: str, x, args, rnd=FLOAT32):
    n, hd, win, shifted = args
    both = conv(p, f"{name}.conv1_1", x, 1, rnd)
    c, t = both[:, :n], both[:, n:]
    r = lrelu(conv(p, f"{name}.conv_block.conv1", c, 1, rnd), rnd)
    r = lrelu(conv(p, f"{name}.conv_block.conv2", r, 1, rnd), rnd)
    c = rnd.results(rnd.results(c + r) + c)
    t = block(p, f"{name}.trans_block", t.permute(0, 2, 3, 1), hd, win, shifted, rnd)
    return rnd.results(x + conv(p, f"{name}.conv1_2", torch.cat([c, t.permute(0, 3, 1, 2)], 1),
                                1, rnd))


def run_layers(p: Params, prefix: str, layers, x, rnd=FLOAT32):
    for i, (kind, args) in enumerate(layers):
        name = f"{prefix}.{i}"
        if kind == "rbs":
            y = lrelu(conv(p, f"{name}.conv1", x, 2, rnd), rnd)
            y = gdn(p, f"{name}.gdn", conv(p, f"{name}.conv2", y, 1, rnd), False, rnd)
            x = rnd.results(y + conv(p, f"{name}.skip", x, 2, rnd))
        elif kind == "rbu":
            y = lrelu(subpel(p, f"{name}.subpel_conv", x, rnd), rnd)
            y = gdn(p, f"{name}.igdn", conv(p, f"{name}.conv", y, 1, rnd), True, rnd)
            x = rnd.results(y + subpel(p, f"{name}.upsample", x, rnd))
        elif kind == "ctb":
            x = ctb(p, name, x, args, rnd)
        elif kind == "conv_s2":
            x = conv(p, name, x, 2, rnd)
        else:
            x = subpel(p, name, x, rnd)
    return x


def swatten(p: Params, name: str, m: dict, x, rnd=FLOAT32):
    u = conv(p, f"{name}.in_conv", x, 1, rnd)
    hd, win = m["swatten_head_dim"], m["window"]
    z = block(p, f"{name}.non_local_block.block_1", u.permute(0, 2, 3, 1), hd, win, False, rnd)
    z = block(p, f"{name}.non_local_block.block_2", z, hd, win, True, rnd).permute(0, 3, 1, 2)

    def unit(pre, v):
        y = torch.relu(conv(p, f"{pre}.conv.0", v, 1, rnd))
        y = torch.relu(conv(p, f"{pre}.conv.2", y, 1, rnd))
        return torch.relu(rnd.results(conv(p, f"{pre}.conv.4", y, 1, rnd) + v))

    a, bb = u, z
    for i in range(3):
        a = unit(f"{name}.conv_a.{i}", a)
        bb = unit(f"{name}.conv_b.{i}", bb)
    bb = conv(p, f"{name}.conv_b.3", bb, 1, rnd)
    gate = rnd.results(torch.sigmoid(bb))
    out = rnd.results(rnd.results(a * gate) + u)
    return conv(p, f"{name}.out_conv", out, 1, rnd)


def cc(p: Params, name: str, x, rnd=FLOAT32):
    x = gelu(conv(p, f"{name}.0", x, 1, rnd), rnd)
    x = gelu(conv(p, f"{name}.2", x, 1, rnd), rnd)
    return conv(p, f"{name}.4", x, 1, rnd)


def gaussian_likelihood(symbols, sigma):
    v = torch.abs(symbols)
    return std_cumulative((0.5 - v) / sigma) - std_cumulative((-0.5 - v) / sigma)


def slice_chain(p: Params, m: dict, y, mean_bar, scale_bar, sent=None, rnd=FLOAT32):
    """The 5-slice chain. sent: the symbols another coder sent (B, M, h,
    w), which the chain decodes in place of its own. Returns the chain's
    own symbols (against its mu), the symbols decoded, y_hat, the decoded
    symbols' likelihoods and the share of sigma at its lower bound."""
    k = m["num_slices"]
    sl = m["m"] // k
    own, used, hats, liks = [], [], [], []
    at_bound = []
    for i in range(k):
        support = [rnd.operands(t) for t in hats[:m["max_support_slices"]]]
        m_mu = swatten(p, f"atten_mean.{i}.0", m, torch.cat([mean_bar] + support, 1), rnd)
        mu = cc(p, f"cc_mean_transforms.{i}", m_mu, rnd)
        m_sigma = swatten(p, f"atten_scale.{i}.0", m, torch.cat([scale_bar] + support, 1), rnd)
        raw_sigma = cc(p, f"cc_scale_transforms.{i}", m_sigma, rnd)
        sigma = torch.clamp(raw_sigma, min=m["scale_lower_bound"])
        at_bound.append(raw_sigma <= m["scale_lower_bound"])
        s = torch.round(y[:, i * sl:(i + 1) * sl] - mu)
        own.append(s)
        if sent is not None:
            s = sent[:, i * sl:(i + 1) * sl]
        used.append(s)
        liks.append(gaussian_likelihood(s, sigma))
        lrp = cc(p, f"lrp_transforms.{i}", torch.cat([m_mu, rnd.operands(s + mu)], 1), rnd)
        hats.append(s + mu + 0.5 * torch.tanh(lrp))
    return (torch.cat(own, 1), torch.cat(used, 1), torch.cat(hats, 1), torch.cat(liks, 1),
            torch.cat(at_bound, 1).float().mean())


def prior_likelihood(p: Params, m: dict, z_hat):
    pre = "entropy_bottleneck."
    sub = {"z_prior." + k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
    return z_likelihood(sub, m, z_hat)


def serve(p: Params, m: dict, images_u8, rnd=FLOAT32, given=None) -> Dict[str, torch.Tensor]:
    """uint8 (B, H, W, 3) -> decoded uint8 (B, H, W, 3), the symbols of y
    and z, bits per image, and the share of sigma at its lower bound.

    given: the symbols another coder sent ({"y_symbols", "z_symbols"}).
    The reference then decodes those, as a receiver would: the hyperprior
    from the given z, then slice by slice its own mu, sigma and LRP from
    its decoding of the given y symbols of the earlier slices, bits of the
    given symbols, the image from its y_hat. Its own z symbols are still
    its encoder's, and its own y symbols are taken against the mu of that
    decoding, so that a symbol flipped by rounding is counted once and
    does not move every later slice; `y_symbols_free` holds its encoder's
    y symbols against its own z and its own chain."""
    _, h, w, _ = images_u8.shape
    k = max(16 * m["window"], 32 * m["hyper_window"], 64)
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    if h % k or w % k:
        x = F.pad(x, (0, -w % k, 0, -h % k), mode="reflect")
    g_a, g_s = _stages(m)
    h_a, h_s = _hyper(m)
    y = run_layers(p, "g_a", g_a, rnd.operands(x), rnd)
    z = run_layers(p, "h_a", h_a, y, rnd)
    offset = p["entropy_bottleneck.offset"].float()[:, None, None]
    z_sym = torch.round(z - offset)

    def bars(z_hat):
        zc = rnd.operands(z_hat)
        return run_layers(p, "h_mean_s", h_s, zc, rnd), run_layers(p, "h_scale_s", h_s, zc, rnd)

    out = {}
    if given is not None:
        free = slice_chain(p, m, y, *bars(z_sym + offset), rnd=rnd)
        out["y_symbols_free"] = free[0]
        z_sent = given["z_symbols"].to(z_sym)
        z_hat = z_sent + offset
        y_own, _, y_hat, lik_y, at_bound = slice_chain(p, m, y, *bars(z_hat),
                                                      sent=given["y_symbols"].to(y), rnd=rnd)
    else:
        z_hat = z_sym + offset
        y_own, _, y_hat, lik_y, at_bound = slice_chain(p, m, y, *bars(z_hat), rnd=rnd)
    floor = m["likelihood_lower_bound"]
    bits = -(torch.log2(torch.clamp(lik_y, min=floor)).sum(dim=(1, 2, 3))
             + torch.log2(torch.clamp(prior_likelihood(p, m, z_hat), min=floor)).sum(dim=(1, 2, 3)))
    x_hat = run_layers(p, "g_s", g_s, rnd.operands(y_hat), rnd)[:, :, :h, :w]
    decoded = torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8)
    out.update({"decoded": decoded.permute(0, 2, 3, 1), "y_symbols": y_own, "z_symbols": z_sym,
                "bits": bits, "sigma_at_bound": at_bound})
    return out
