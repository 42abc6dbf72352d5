"""Work of TCM's bf16 serving configuration, from its shapes, per image of
h x w pixels (multiples of 128), counted as harness/flops.py counts: 2
FLOPs a multiply-add of every convolution (GDN's 1x1 product of x^2
included), every linear and both products of every window's attention
(each window once), and of the factorized prior's products (each value of
z_hat taken at +-0.5); LN, GDN's root, the activations, the roundings and
the likelihoods do not count.

At 2048 x 1536 (published widths): 11.62 TFLOP an image, of which g_a
4.34, g_s 6.50, the hyperprior 0.09 and the slice chain 0.69; the 38
windowed Blocks 1.87 (and 2.26 GB).

`swin`: FLOPs and bytes of every windowed Block (g_a's and g_s's 12, the
hyperprior's 6, the SWAttens' 20), each reading its input and writing its
output once and reading its weights, in bf16 (2-byte elements).
"""

ELEM_BYTES = 2


def _conv(px: float, cin: int, cout: int, k: int) -> float:
    return 2.0 * px * cin * cout * k * k


def _rbs(px_out: float, a: int, b: int) -> float:
    return _conv(px_out, a, b, 3) + _conv(px_out, b, b, 3) + _conv(px_out, b, b, 1) \
        + _conv(px_out, a, b, 1)


def _rbu(px_in: float, a: int, b: int) -> float:
    px_out = 4 * px_in
    return 2 * _conv(px_in, a, 4 * b, 3) + _conv(px_out, b, b, 3) + _conv(px_out, b, b, 1)


def block(tokens: float, d: int, win: int, head_dim: int):
    """(FLOPs, bytes) of one windowed Block over `tokens` tokens of width d:
    QKV, both window products, the projection, the MLP; its input and
    output once and its weights (LN's, the linears', the bias table)."""
    fl = 24.0 * tokens * d * d + 4.0 * tokens * win * win * d
    weights = 12 * d * d + 13 * d + (2 * win - 1) ** 2 * (d // head_dim)
    return fl, ELEM_BYTES * (2.0 * tokens * d + weights)


def _ctb(px: float, n: int, win: int) -> float:
    return 2 * _conv(px, 2 * n, 2 * n, 1) + 2 * _conv(px, n, n, 3) + block(px, n, win, 1)[0]


def _swatten(px: float, cin: int, d: int, win: int) -> float:
    unit = _conv(px, d, d // 2, 1) + _conv(px, d // 2, d // 2, 3) + _conv(px, d // 2, d, 1)
    return _conv(px, cin, d, 1) + 2 * block(px, d, win, 1)[0] + 6 * unit + _conv(px, d, d, 1) \
        + _conv(px, d, cin, 1)


def _cc(px: float, cin: int, widths, cout: int) -> float:
    dims = [cin] + list(widths) + [cout]
    return sum(_conv(px, a, b, 3) for a, b in zip(dims, dims[1:]))


def parts(m: dict, h: int, w: int) -> dict:
    """FLOPs of g_a, g_s, the hyperprior (h_a, both syntheses, the prior)
    and the slice chain, per image."""
    n, mm, win, hw = m["n"], m["m"], m["window"], m["hyper_window"]
    blocks = m["stage_blocks"]
    px = float(h * w)
    g_a = _rbs(px / 4, m["channels"], 2 * n) + blocks[0] * _ctb(px / 4, n, win)
    g_a += _rbs(px / 16, 2 * n, 2 * n) + blocks[1] * _ctb(px / 16, n, win)
    g_a += _rbs(px / 64, 2 * n, 2 * n) + blocks[2] * _ctb(px / 64, n, win)
    g_a += _conv(px / 256, 2 * n, mm, 3)
    g_s = _rbu(px / 256, mm, 2 * n) + blocks[3] * _ctb(px / 64, n, win)
    g_s += _rbu(px / 64, 2 * n, 2 * n) + blocks[4] * _ctb(px / 16, n, win)
    g_s += _rbu(px / 16, 2 * n, 2 * n) + blocks[5] * _ctb(px / 4, n, win)
    g_s += _conv(px / 4, 2 * n, 4 * m["channels"], 3)
    zc = m["z_channels"]
    hyper = _rbs(px / 1024, mm, 2 * n) + blocks[0] * _ctb(px / 1024, n, hw)
    hyper += _conv(px / 4096, 2 * n, zc, 3)
    hyper += 2 * (_rbu(px / 4096, zc, 2 * n) + blocks[3] * _ctb(px / 1024, n, hw)
                  + _conv(px / 1024, 2 * n, 4 * mm, 3))
    dims = [1] + list(m["factorized_filters"]) + [1]
    hyper += 2 * 2.0 * zc * px / 4096 * sum(a * b for a, b in zip(dims, dims[1:]))
    k, sup = m["num_slices"], m["max_support_slices"]
    sl = mm // k
    lat = px / 256
    chain = 0.0
    for i in range(k):
        cin = mm + sl * min(i, sup)
        chain += 2 * (_swatten(lat, cin, m["swatten_dim"], win) + _cc(lat, cin, m["cc_widths"], sl))
        chain += _cc(lat, mm + sl * min(i + 1, sup + 1), m["cc_widths"], sl)
    return {"g_a": g_a, "g_s": g_s, "hyperprior": hyper, "slices": chain}


def flops_per_image(m: dict, h: int, w: int) -> float:
    return sum(parts(m, h, w).values())


def swin(m: dict, h: int, w: int):
    """(FLOPs, bytes) of all windowed Blocks, per image."""
    n, win, hw = m["n"], m["window"], m["hyper_window"]
    blocks = m["stage_blocks"]
    px = float(h * w)
    hd = m["head_dims"]
    members = [(px / 4, n, win, hd[0], blocks[0]), (px / 16, n, win, hd[1], blocks[1]),
               (px / 64, n, win, hd[2], blocks[2]), (px / 64, n, win, hd[3], blocks[3]),
               (px / 16, n, win, hd[4], blocks[4]), (px / 4, n, win, hd[5], blocks[5]),
               (px / 1024, n, hw, m["hyper_head_dim"], blocks[0] + 2 * blocks[3]),
               (px / 256, m["swatten_dim"], win, m["swatten_head_dim"], 4 * m["num_slices"])]
    fl = by = 0.0
    for tokens, d, wn, head_dim, count in members:
        f, b = block(tokens, d, wn, head_dim)
        fl += count * f
        by += count * b
    return fl, by
