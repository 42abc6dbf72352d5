"""Weight carrier between the JAX package's variables and the port's modules.

JAX -> port. Input: JAX variables as nested dicts of numpy arrays: the
codec's `{component: {"params": ..., "batch_stats": ...}}` (what
`AdaptiveCodec.init` returns), the discriminator's, the autoencoder's and
the VGG19 tower's `{"params": ..., ["batch_stats": ...]}`, and the
optimizer states. Output: state dicts of the port's `AdaptiveCodec`,
`Discriminator`, `Autoencoder` and `VGG19Features`, and the torch Adam
states of the four keras-Adam optimizers. Rules:

  * conv kernels HWIO -> OIHW;
  * ConvTranspose kernels (kh, kw, Cin, Cout) are flipped on both spatial
    axes and laid out (Cin, Cout, kh, kw), which makes flax's SAME
    transposed conv equal F.conv_transpose2d(stride=2, padding=1);
  * Dense (in, out) -> (out, in);
  * BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var (eps 1e-3 lives in the module);
  * the encoder and the discriminator flatten and the generator reshapes in
    NHWC order in JAX: the encoders' latent_dense rows, the discriminator's
    dense rows and the generators' fc columns and bias are permuted to NCHW
    order here, so the port needs no run-time permute.
    The w8 scales are per output column, so quantizing after the
    permutation gives the same numbers.

Port -> JAX (`codec_variables`, `discriminator_variables`,
`autoencoder_variables`, `optimizer_variables`): the inverse of every rule,
each a permutation, flip or transpose, so a round trip is exact; keys come
out sorted at every level, the order in which the JAX package's
checkpoints hold them (`jax.tree.map` sorts dict keys), so a tree read from
a JAX file, carried to the port and back writes the same bytes.

Optimizer states. The JAX optimizers are `optax.chain(clip_per_leaf_norm,
adam)`, whose flax state dict is {"0": {}, "1": {"0": {"count", "mu",
"nu"}, "1": {}}}: `mu` / `nu` mirror the group's params tree and map to
torch Adam's `exp_avg` / `exp_avg_sq` through the layout map of their
parameter; the int32 `count` is each parameter's Adam `step`. The
`optimizers` component holds the four states and the train step.

The mask engine (K1, K4) and the DCT baseline codec (K5) have no
parameters, so nothing here covers them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from contextual_image_compression_tpu_torch.config import ModelConfig
from contextual_image_compression_tpu_torch.models.adaptive import (
    ALL_CODEC_COMPONENTS,
    GENERATOR_COMPONENTS,
    LATENT_SALIENCY_COMPONENTS,
    RD_COMPONENTS,
)
from contextual_image_compression_tpu_torch.models.discriminator import disc_geometry
from contextual_image_compression_tpu_torch.models.layers import (
    KBatchNorm,
    KConv,
    KConvT,
    KDense,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _component_state(tree: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def join(prefix, key):
        return f"{prefix}.{key}" if prefix else key

    def walk_params(d, prefix):
        for key, val in d.items():
            if key == "Conv_0":
                sd[join(prefix, "weight")] = _t(val["kernel"]).permute(3, 2, 0, 1).contiguous()
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "ConvTranspose_0":
                k = _t(val["kernel"]).flip(0, 1)
                sd[join(prefix, "weight")] = k.permute(2, 3, 0, 1).contiguous()
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "Dense_0":
                sd[join(prefix, "weight")] = _t(val["kernel"]).T.contiguous()
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "BatchNorm_0":
                sd[join(prefix, "weight")] = _t(val["scale"])
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "gamma":
                sd[join(prefix, "gamma")] = _t(val).reshape(1)
            elif isinstance(val, dict):
                walk_params(val, join(prefix, key))
            else:
                raise KeyError(f"unexpected parameter {join(prefix, key)}")

    def walk_stats(d, prefix):
        for key, val in d.items():
            if key == "BatchNorm_0":
                sd[join(prefix, "running_mean")] = _t(val["mean"])
                sd[join(prefix, "running_var")] = _t(val["var"])
            elif isinstance(val, dict):
                walk_stats(val, join(prefix, key))

    walk_params(tree["params"], "")
    walk_stats(tree.get("batch_stats", {}), "")
    return sd


def _nhwc_rows_to_nchw(w: torch.Tensor, h: int, wd: int, c: int) -> torch.Tensor:
    """Dense weight (out, h*w*c in NHWC order) -> (out, c*h*w in NCHW order)."""
    out = w.shape[0]
    return w.reshape(out, h, wd, c).permute(0, 3, 1, 2).reshape(out, c * h * wd).contiguous()


def _nhwc_cols_to_nchw(w: torch.Tensor, b: torch.Tensor, h: int, wd: int, c: int):
    """Dense weight (h*w*c out in NHWC order, in) and bias -> NCHW order."""
    cin = w.shape[1]
    w2 = w.reshape(h, wd, c, cin).permute(2, 0, 1, 3).reshape(c * h * wd, cin).contiguous()
    b2 = b.reshape(h, wd, c).permute(2, 0, 1).reshape(-1).contiguous()
    return w2, b2


def component_state(name: str, tree: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One JAX component's variables -> the state dict of the port's module
    of that component (keys without the component prefix)."""
    csd = _component_state(tree)
    h, w = cfg.img_size
    if name.endswith("_encoder"):
        csd["latent_dense.weight"] = _nhwc_rows_to_nchw(
            csd["latent_dense.weight"], h // 16, w // 16, cfg.encoder_channels[3]
        )
    elif name.endswith("_generator"):
        n = cfg.generator_base_hw
        csd["fc.weight"], csd["fc.bias"] = _nhwc_cols_to_nchw(
            csd["fc.weight"], csd["fc.bias"], n, n, cfg.generator_base_ch
        )
    return csd


def convert_codec_variables(variables: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX codec variables (numpy leaves) -> state dict of the port's AdaptiveCodec."""
    return {
        f"{comp}.{key}": val
        for comp, tree in variables.items()
        for key, val in component_state(comp, tree, cfg).items()
    }


def convert_discriminator_variables(variables: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX discriminator variables (numpy leaves) -> state dict of the port's
    Discriminator, with the NHWC-order `dense` rows permuted to NCHW."""
    sd = _component_state(variables)
    filters, hw = disc_geometry(cfg.img_size, cfg.disc_base_filters, cfg.disc_max_filters,
                                cfg.disc_max_stages)
    sd["dense.weight"] = _nhwc_rows_to_nchw(sd["dense.weight"], hw, hw, filters[-1])
    return sd


def convert_vgg_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX VGG19Features variables {"params": {block{i}_conv{j}: {kernel
    (HWIO), bias}}} -> state dict of the port's VGG19Features (OIHW)."""
    return {
        f"{name}.{key}": (_t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
                          if key == "weight" else _t(leaf["bias"]))
        for name, leaf in variables["params"].items()
        for key in ("weight", "bias")
    }


def convert_autoencoder_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX Autoencoder variables {"params": {name: {"Conv_0": ...}}} -> state
    dict of the port's Autoencoder."""
    return _component_state(variables)


# ------------------------------------------------------------- port -> JAX

Leaf = Callable[[torch.Tensor], object]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A JAX-layout leaf as a C-contiguous numpy array (a copy on the host)."""
    return t.detach().contiguous().cpu().numpy()


def placeholder(t: torch.Tensor) -> np.ndarray:
    """A leaf's shape and dtype and nothing else (a zero-stride numpy view):
    enough for a load template, whose values the ladder never reads."""
    dtype = torch.empty((), dtype=t.dtype).numpy().dtype
    return np.broadcast_to(np.zeros((), dtype), tuple(t.shape))


def _sorted(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}


_KERNEL_RULES = {
    KConv: ("Conv_0", lambda w: w.permute(2, 3, 1, 0)),                # OIHW -> HWIO
    KConvT: ("ConvTranspose_0", lambda w: w.permute(2, 3, 0, 1).flip(0, 1)),
    KDense: ("Dense_0", lambda w: w.t()),
}


def _jax_tree(module: torch.nn.Module, tensors: Dict[str, torch.Tensor], leaf: Leaf) -> Dict:
    """The JAX variables of `module` from `tensors` (its state-dict keys, in
    the port's layouts): {"batch_stats": ..., "params": ...}, keys sorted.
    Keys absent from `tensors` are left out (an optimizer moment has no
    running statistics), and so is a collection left empty."""
    out: Dict = {}

    def put(collection, path, key, value):
        node = out.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[key] = leaf(value)

    for name, mod in module.named_modules():
        path = name.split(".") if name else []
        pre = f"{name}." if name else ""

        def have(key):
            return pre + key in tensors

        if type(mod) in _KERNEL_RULES:
            inner, rule = _KERNEL_RULES[type(mod)]
            if have("weight"):
                put("params", path + [inner], "kernel", rule(tensors[pre + "weight"]))
            if have("bias"):
                put("params", path + [inner], "bias", tensors[pre + "bias"])
        elif isinstance(mod, KBatchNorm):
            for key, collection, jkey in (("weight", "params", "scale"), ("bias", "params", "bias"),
                                          ("running_mean", "batch_stats", "mean"),
                                          ("running_var", "batch_stats", "var")):
                if have(key):
                    put(collection, path + ["BatchNorm_0"], jkey, tensors[pre + key])
        else:  # a parameter of its own, e.g. the SAGAN gamma
            for key, _ in mod.named_parameters(recurse=False):
                if have(key):
                    put("params", path, key, tensors[pre + key])
    return _sorted(out)


def _nchw_rows_to_nhwc(w: torch.Tensor, h: int, wd: int, c: int) -> torch.Tensor:
    """Inverse of _nhwc_rows_to_nchw."""
    return w.reshape(w.shape[0], c, h, wd).permute(0, 2, 3, 1).reshape(w.shape[0], h * wd * c)


def _nchw_cols_to_nhwc(w: torch.Tensor, b: torch.Tensor, h: int, wd: int, c: int):
    """Inverse of _nhwc_cols_to_nchw."""
    cin = w.shape[1]
    w2 = w.reshape(c, h, wd, cin).permute(1, 2, 0, 3).reshape(h * wd * c, cin)
    return w2, b.reshape(c, h, wd).permute(1, 2, 0).reshape(-1)


def _port_tensors(module: torch.nn.Module, tensors: Optional[Dict[str, torch.Tensor]],
                  leaf: Leaf) -> Dict[str, torch.Tensor]:
    sd = module.state_dict() if tensors is None else dict(tensors)
    if leaf is placeholder:  # shapes only: the layout maps run on meta tensors
        sd = {k: v.to("meta") for k, v in sd.items()}
    return sd


def component_variables(name: str, module: torch.nn.Module, cfg: ModelConfig,
                        tensors: Optional[Dict[str, torch.Tensor]] = None,
                        leaf: Leaf = to_host) -> Dict:
    """Inverse of `component_state`: a codec component's JAX variables from
    its module (structure) and `tensors` (its state dict by default)."""
    sd = _port_tensors(module, tensors, leaf)
    h, w = cfg.img_size
    if name.endswith("_encoder") and "latent_dense.weight" in sd:
        sd["latent_dense.weight"] = _nchw_rows_to_nhwc(
            sd["latent_dense.weight"], h // 16, w // 16, cfg.encoder_channels[3])
    elif name.endswith("_generator") and "fc.weight" in sd:
        n = cfg.generator_base_hw
        sd["fc.weight"], sd["fc.bias"] = _nchw_cols_to_nhwc(
            sd["fc.weight"], sd["fc.bias"], n, n, cfg.generator_base_ch)
    return _jax_tree(module, sd, leaf)


def codec_variables(codec: torch.nn.Module, leaf: Leaf = to_host,
                    tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Inverse of `convert_codec_variables`: {component: JAX variables} of
    the port's AdaptiveCodec (from `tensors`, keyed as its state dict, when
    given)."""
    sd = _port_tensors(codec, tensors, leaf)
    out = {}
    for comp in ALL_CODEC_COMPONENTS:
        pre = comp + "."
        part = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        out[comp] = component_variables(comp, getattr(codec, comp), codec.cfg, part, leaf)
    return out


def discriminator_variables(disc: torch.nn.Module, cfg: ModelConfig,
                            tensors: Optional[Dict[str, torch.Tensor]] = None,
                            leaf: Leaf = to_host) -> Dict:
    """Inverse of `convert_discriminator_variables`."""
    sd = _port_tensors(disc, tensors, leaf)
    filters, hw = disc_geometry(cfg.img_size, cfg.disc_base_filters, cfg.disc_max_filters,
                                cfg.disc_max_stages)
    if "dense.weight" in sd:
        sd["dense.weight"] = _nchw_rows_to_nhwc(sd["dense.weight"], hw, hw, filters[-1])
    return _jax_tree(disc, sd, leaf)


def autoencoder_variables(model: torch.nn.Module, leaf: Leaf = to_host,
                          tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Inverse of `convert_autoencoder_variables`."""
    return _jax_tree(model, _port_tensors(model, tensors, leaf), leaf)


# -------------------------------------------------------- optimizer states

# The parameter groups of the four keras-Adam optimizers of GAN training
# (None: the discriminator's parameters).
OPTIMIZER_GROUPS = {"d_opt": None, "g_opt": GENERATOR_COMPONENTS,
                    "ls_opt": LATENT_SALIENCY_COMPONENTS, "rd_opt": RD_COMPONENTS}


def _group_modules(state, opt_name):
    group = OPTIMIZER_GROUPS[opt_name]
    if group is None:
        return [(None, state.disc)]
    return [(n, getattr(state.codec, n)) for n in group]


def _moments(adam: torch.optim.Optimizer, module: torch.nn.Module):
    """exp_avg and exp_avg_sq of each parameter (zeros before the first
    step), keyed as the module's state dict, and the Adam step."""
    mu, nu, steps = {}, {}, set()
    for key, p in module.named_parameters():
        st = adam.state.get(p, {})
        zero = p.detach().new_zeros(()).expand(p.shape)  # no memory until written
        mu[key] = st.get("exp_avg", zero)
        nu[key] = st.get("exp_avg_sq", zero)
        steps.add(int(st["step"]) if "step" in st else 0)
    return mu, nu, steps


def optimizer_variables(state, leaf: Leaf = to_host,
                        moments: Optional[Dict] = None) -> Dict:
    """The JAX `optimizers` component of a GAN train state: the four Adam
    states as flax state dicts and the step (int32, 0-d). `state` has the
    port's GANTrainState fields; `moments`, when given, is
    `optimizer_moments(state)` taken earlier (a snapshot), else it is taken
    now."""
    moments = moments if moments is not None else optimizer_moments(state)
    cfg = state.codec.cfg
    out = {}
    for opt_name in OPTIMIZER_GROUPS:
        trees, count = {}, moments[opt_name]["count"]
        for which in ("mu", "nu"):
            per = {}
            for comp, module in _group_modules(state, opt_name):
                sd = moments[opt_name][which][comp]
                if comp is None:
                    per = discriminator_variables(module, cfg, sd, leaf)["params"]
                else:
                    per[comp] = component_variables(comp, module, cfg, sd, leaf)["params"]
            trees[which] = _sorted(per)
        adam = {"count": np.asarray(count, np.int32), "mu": trees["mu"], "nu": trees["nu"]}
        out[opt_name] = {"0": {}, "1": {"0": adam, "1": {}}}
    out["step"] = np.asarray(moments["step"], np.int32)
    return out


def optimizer_moments(state) -> Dict:
    """{opt: {"mu": {comp: sd}, "nu": {comp: sd}, "count": int}, "step":
    int} of a GAN train state (the live tensors)."""
    out: Dict = {"step": int(state.step)}
    for opt_name in OPTIMIZER_GROUPS:
        adam = getattr(state, opt_name).adam
        mus, nus, steps = {}, {}, set()
        for comp, module in _group_modules(state, opt_name):
            mus[comp], nus[comp], s = _moments(adam, module)
            steps |= s
        if len(steps) > 1:
            raise ValueError(f"{opt_name}: its parameters are at different Adam steps {steps}")
        out[opt_name] = {"mu": mus, "nu": nus, "count": steps.pop()}
    return out


def load_optimizer_variables(state, tree: Dict) -> None:
    """Set the four Adam states and the step of a GAN train state (the
    port's GANTrainState fields) from the JAX `optimizers` component."""
    cfg = state.codec.cfg
    for opt_name in OPTIMIZER_GROUPS:
        adam_tree = tree[opt_name]["1"]["0"]
        count = int(np.asarray(adam_tree["count"]))
        adam = getattr(state, opt_name).adam
        for comp, module in _group_modules(state, opt_name):
            if comp is None:
                mu = convert_discriminator_variables({"params": adam_tree["mu"]}, cfg)
                nu = convert_discriminator_variables({"params": adam_tree["nu"]}, cfg)
            else:
                mu = component_state(comp, {"params": adam_tree["mu"][comp]}, cfg)
                nu = component_state(comp, {"params": adam_tree["nu"][comp]}, cfg)
            params = dict(module.named_parameters())
            if set(mu) != set(params) or set(nu) != set(params):
                raise KeyError(f"{opt_name} / {comp}: moments {sorted(set(mu) ^ set(params))} "
                               "do not match the parameters")
            for key, p in params.items():
                adam.state[p] = {
                    # torch keeps a non-capturable Adam's step on the host, float32
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": mu[key].to(p.device),
                    "exp_avg_sq": nu[key].to(p.device),
                }
    state.step = int(np.asarray(tree["step"]))
