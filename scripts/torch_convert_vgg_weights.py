#!/usr/bin/env python
"""Convert public VGG19 weights to the .npz layout that models/vgg.py reads,
with the flags, printed lines, checks and output of
scripts/convert_vgg_weights.py.

It accepts
  * a torchvision `vgg19*.pth` state dict (read with
    `torch.load(weights_only=True)`), or
  * a keras VGG19 `.h5` (notop) checkpoint, read through h5py (imported
    only for an .h5; where it does not import the script raises naming it),
and writes an .npz with keys 'block{i}_conv{j}_kernel' (HWIO) and
'block{i}_conv{j}_bias' that both packages' `load_vgg19_features` read.
With the file present, `TrainConfig.vgg_weights_path` turns the perceptual
loss on.

    python scripts/torch_convert_vgg_weights.py vgg19-dcbb9e9d.pth vgg19_imagenet.npz
    python scripts/torch_train_gan.py --data-dir dataset --vgg-weights vgg19_imagenet.npz

Checks, so that a bad file fails at conversion and not in training:
  * the source's sha256 is printed, and a torch-hub file name's hash prefix
    (`vgg19-dcbb9e9d.pth`) is checked against it;
  * every kernel and bias is shape-checked against the VGG19 layout;
  * the tap-activation fingerprint (per-tap [mean, std] on a fixed batch,
    models/vgg.py::compute_tap_fingerprint) of the converted tower is
    stored in the file, and the loader re-verifies it at every load.

The fingerprint's tower runs on the card; main(device="cpu") runs it on the
CPU.
"""

import argparse
import hashlib
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TAP_NAMES = ("block1_conv2", "block2_conv2", "block3_conv4", "block4_conv4", "block5_conv4")


def convert_torch(path: str) -> dict:
    import torch

    from contextual_image_compression_tpu_torch.models.vgg import VGG19_LAYOUT

    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    # torchvision vgg19.features: a conv every 2 indices (conv, relu), a
    # max-pool after each block
    out, idx = {}, 0
    for bi, (_, n_convs) in enumerate(VGG19_LAYOUT, start=1):
        for ci in range(1, n_convs + 1):
            w = state[f"features.{idx}.weight"].numpy()  # OIHW
            out[f"block{bi}_conv{ci}_kernel"] = np.transpose(w, (2, 3, 1, 0))  # HWIO
            out[f"block{bi}_conv{ci}_bias"] = state[f"features.{idx}.bias"].numpy()
            idx += 2
        idx += 1
    return out


def convert_keras_h5(path: str) -> dict:
    from contextual_image_compression_tpu_torch.models.vgg import VGG19_LAYOUT

    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("reading a keras .h5 needs h5py, which does not import here") from e
    out = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for bi, (_, n_convs) in enumerate(VGG19_LAYOUT, start=1):
            for ci in range(1, n_convs + 1):
                name = f"block{bi}_conv{ci}"
                grp = root[name]
                inner = grp[name] if name in grp else grp  # keras nests name/name/kernel:0
                out[f"{name}_kernel"] = np.array(inner["kernel:0"])  # already HWIO
                out[f"{name}_bias"] = np.array(inner["bias:0"])
    return out


def check_source_digest(path: str) -> str:
    """sha256 of the source; a torch-hub file name's hash prefix must match."""
    digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()
    m = re.search(r"-([0-9a-f]{8,64})\.(?:pth|pt)$", Path(path).name)
    if m:
        prefix = m.group(1)
        if not digest.startswith(prefix):
            raise SystemExit(
                f"source {path} sha256 {digest[:16]}... does not start with the "
                f"hash prefix '{prefix}' embedded in its filename -- the "
                "download is corrupt or renamed. Re-download it.")
        print(f"source sha256 {digest} (filename prefix '{prefix}' verified)")
    else:
        print(f"source sha256 {digest}")
    return digest


def check_shapes(weights: dict) -> None:
    from contextual_image_compression_tpu_torch.models.vgg import VGG19_LAYOUT

    cin = 3
    for bi, (width, n_convs) in enumerate(VGG19_LAYOUT, start=1):
        for ci in range(1, n_convs + 1):
            name = f"block{bi}_conv{ci}"
            k, b = weights[f"{name}_kernel"], weights[f"{name}_bias"]
            want = (3, 3, cin, width)
            if tuple(k.shape) != want or tuple(b.shape) != (width,):
                raise SystemExit(
                    f"{name}: kernel {k.shape} / bias {b.shape}, expected "
                    f"{want} / {(width,)} -- not a VGG19 checkpoint?")
            cin = width


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source", help=".h5 (keras) or .pth (torchvision) VGG19 weights")
    p.add_argument("output", help="output .npz path")
    args = p.parse_args(argv)

    import torch

    from contextual_image_compression_tpu_torch.config import resolve_device
    from contextual_image_compression_tpu_torch.models import vgg

    dev = resolve_device(device)
    check_source_digest(args.source)
    if args.source.endswith((".pth", ".pt")):
        weights = convert_torch(args.source)
    else:
        weights = convert_keras_h5(args.source)
    check_shapes(weights)

    # Fingerprint the converted tower and store it in the file; the loader
    # re-verifies it at every load.
    with torch.device(dev):
        tower = vgg.VGG19Features()
    sd = {}
    for name in vgg.conv_names():
        kernel = np.asarray(weights[f"{name}_kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(weights[f"{name}_bias"], np.float32))
    tower.load_state_dict(sd)
    fp = vgg.compute_tap_fingerprint(tower)
    weights[vgg.FINGERPRINT_KEY] = fp
    print("tap fingerprint [mean, std] per reference tap:")
    for tap, row in zip(TAP_NAMES, fp):
        print(f"  {tap}: mean {row[0]:.4f}  std {row[1]:.4f}")

    np.savez(args.output, **weights)
    out_digest = hashlib.sha256(Path(args.output).read_bytes()).hexdigest()
    print(f"Wrote {len(weights)} arrays to {args.output} (sha256 {out_digest})")

    # Load-path self-check: exactly what training will do.
    module = vgg.load_vgg19_features(args.output, dev)
    assert module is not None, "loader rejected the file it just verified?"
    print("loader fingerprint re-verification: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
