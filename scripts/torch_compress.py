#!/usr/bin/env python
"""File compression and decompression with the PyTorch port's DCT codec
(kernel K5) and range coder, with the flags, printed lines and files of
scripts/compress.py: its .cic streams are the JAX script's, byte for byte.

  python scripts/torch_compress.py encode img1.png img2.jpg --out-dir compressed/
  python scripts/torch_compress.py decode compressed/*.cic --out-dir restored/

It runs on the card; main(device="cpu") runs it on the CPU.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["encode", "decode"])
    p.add_argument("files", nargs="+")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--quality", type=int, default=75)
    p.add_argument("--size", type=int, default=0,
                   help="resize to SxS before encoding (0 = pad to /8)")
    args = p.parse_args(argv)

    import numpy as np

    from contextual_image_compression_tpu_torch.config import DCTCodecConfig
    from contextual_image_compression_tpu_torch.data import images as I
    from contextual_image_compression_tpu_torch.ops.dct import DCTCodec

    os.makedirs(args.out_dir, exist_ok=True)
    codec = DCTCodec(DCTCodecConfig(quality=args.quality), device=device)

    if args.mode == "encode":
        total_in = total_out = 0
        for f in args.files:
            if args.size:
                img = I.load_and_preprocess_image(f, (args.size, args.size))
            else:
                raw = I._read_rgb(f)
                if raw is None:
                    print(f"skip (unreadable): {f}")
                    continue
                h, w = (raw.shape[0] // 8) * 8, (raw.shape[1] // 8) * 8
                img = (raw[:h, :w].astype(np.float32) - 127.5) / 127.5
            stream = codec.encode_stream(img)
            out = os.path.join(
                args.out_dir, os.path.splitext(os.path.basename(f))[0] + ".cic"
            )
            with open(out, "wb") as fh:
                fh.write(stream)
            in_size = os.path.getsize(f)
            total_in += in_size
            total_out += len(stream)
            bpp = 8 * len(stream) / (img.shape[0] * img.shape[1])
            print(f"{f} -> {out}: {in_size} -> {len(stream)} B ({bpp:.3f} bpp)")
        if total_in:
            print(f"total: {total_in} -> {total_out} B "
                  f"({(1 - total_out / total_in) * 100:.1f}% reduction)")
    else:
        for f in args.files:
            with open(f, "rb") as fh:
                data = fh.read()
            img = codec.decode_stream(data)
            out = os.path.join(
                args.out_dir, os.path.splitext(os.path.basename(f))[0] + ".png"
            )
            I.save_image(img.cpu().numpy(), out)
            print(f"{f} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
