"""Shared helpers of the tests that hold the PyTorch port against the JAX
package and its kernels against their twins (this module imports no JAX)."""

import numpy as np
import torch


def to_numpy_tree(tree):
    """A JAX variables tree with numpy float32 leaves."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.array(tree, dtype=np.float32)


def perturb_variables(tree, rng, gamma=0.5):
    """Give BatchNorm non-trivial stats, scales and biases, and the SAGAN
    gamma a nonzero value (it initializes at 0, which hides attention)."""

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.array(v, np.float32)
            if k == "gamma":
                a = np.full_like(a, gamma)
            elif k == "mean":
                a = (rng.randn(*a.shape) * 0.1).astype(np.float32)
            elif k in ("var", "scale"):
                a = (rng.rand(*a.shape) * 0.5 + 0.75).astype(np.float32)
            elif k == "bias":
                a = (rng.randn(*a.shape) * 0.05).astype(np.float32)
            out[k] = a
        return out

    return walk(tree)


def nchw(x):
    """NHWC numpy/JAX array -> NCHW float tensor."""
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2).contiguous()


def nhwc(t):
    """NCHW tensor -> NHWC float32 numpy."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def late_max_attention_inputs(c=0.35, seed=1000):
    """bf16 q, k (2, 1024, 32) and v (2, 1024, 256) on the CPU, from a numpy
    seed, whose every row's largest score is at key 1000, in the last 64-key
    tile, a little above the earlier keys' (q k is ~1.3 above the best of
    keys 0..959 on average, and key 1000 holds ~1.5% of a row's weight).
    So most of each output comes from tiles that a running-max softmax would
    have rounded at a smaller max than the row's."""
    rng = np.random.RandomState(seed)
    q = rng.rand(2, 1024, 32) * 0.5
    k = rng.randn(2, 1024, 32) * 0.3
    k[:, 1000] = c
    v = rng.randn(2, 1024, 256)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in (q, k, v))


def attention_running_max(q, k, v, residual=None, gamma=None, tile=64):
    """softmax(Q K^T) V as an online softmax over key tiles (K6; K2's
    (gamma / l) acc + residual when a residual is given): e = exp(s - m)
    rounded to V's dtype at the running max m of the tiles so far, the
    float32 accumulator and row sum rescaled by exp(m_old - m_new). The
    TPU kernels round e once at the row's global max; this is the rounding
    they do not do, to show that a test can tell the two apart."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b, n, _ = q.shape
    m = torch.full((b, n, 1), -float("inf"))
    l = torch.zeros(b, n, 1)
    acc = torch.zeros(b, n, v.shape[-1])
    for t0 in range(0, k.shape[1], tile):
        s = torch.einsum("bnd,bmd->bnm", qf, kf[:, t0:t0 + tile])
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bnm,bmd->bnd", e.to(v.dtype).float(), vf[:, t0:t0 + tile])
        m = m_new
    if residual is None:
        return (acc * (1.0 / l)).to(q.dtype)
    return ((float(gamma) * (1.0 / l)) * acc + residual.float()).to(q.dtype)
