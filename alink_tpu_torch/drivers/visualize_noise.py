"""Render a noise channel onto an image (counterpart of
``alink_tpu/drivers/visualize_noise.py``; the reference's
visualize_noise.py, which writes perlin noise on one hard-coded image).

The image, channel, seed and output path are flags; every channel of
``ops.noise.get_relevant_noise`` renders, its draws from a
``torch.Generator`` seeded with ``--seed`` on ``--device`` (the card
unless ``--device cpu``).

    python -m alink_tpu_torch.drivers.visualize_noise --image face.png \\
        --noise perlin --out noise_preview.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from alink_tpu_torch.drivers.common import resolve_device
from alink_tpu_torch.ops import noise


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image", required=True, help="input image path")
    parser.add_argument("--noise", default="perlin",
                        help="channel name (noise.get_relevant_noise)")
    parser.add_argument("--out", default="noise_preview.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device, "visualize_noise")
    img = np.asarray(Image.open(args.image).convert("RGB"), np.float32)
    fn = noise.get_relevant_noise(args.noise)
    g = torch.Generator(dev).manual_seed(args.seed)
    noisy = fn(g, torch.as_tensor(img, device=dev)[None])[0]
    out = np.clip(noisy.float().cpu().numpy(), 0, 255).astype(np.uint8)
    Image.fromarray(out).save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
