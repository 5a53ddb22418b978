"""Quality of generated images against targets (counterpart of
tools/eval_quality.py): L1, SSIM, PSNR, the Fréchet proxy and, given
InceptionV3 weights, FID.

    python -m gan_tpu_torch.tools.eval_quality --generated DIR_A --target DIR_B [--channels 1]
    # a trainer's predictions against the paired test halves, matched by stem:
    python -m gan_tpu_torch.tools.eval_quality --pairs DATA_DIR --generated PRED_DIR
    # true FID over pool3 features, with an .npz from tools/import_inception_weights.py:
    ... --fid-weights iv3.npz

gan_tpu's flags and JSON report (``n_images``, ``l1``, ``ssim``, ``psnr_db``,
``frechet_proxy`` and, with ``--fid-weights``, ``fid``). The images are
decoded and nearest-resized on the host, and scored on the card unless
``GAN_TPU_PLATFORM=cpu`` (gan_tpu_torch.device); the Fréchet distances'
``sqrtm`` runs on the host in float64. Only a pretrained weights file makes
``fid`` comparable to published numbers; a random one gives a structured proxy.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gan_tpu_torch import quality
from gan_tpu_torch.data.pipeline import build_cyclegan_cache, build_pix2pix_cache
from gan_tpu_torch.device import default_device
from gan_tpu_torch.models.inception import extract_features, load_params


def _image_names(d: str) -> list[str]:
    return sorted(n for n in os.listdir(d) if "png" in n or "jpg" in n)


def _load(d: str, names: list[str], channels: int, size: int) -> np.ndarray:
    """Each image decoded and nearest-resized to ``size`` (CycleGAN's val rows), in [-1, 1]."""
    imgs = build_cyclegan_cache([os.path.join(d, n) for n in names], img_size=size,
                                channels=channels)
    return imgs.astype(np.float32) / 127.5 - 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("eval_quality")
    ap.add_argument("--generated", required=True, help="dir of generated images")
    ap.add_argument("--target", default=None, help="dir of ground-truth images")
    ap.add_argument("--pairs", default=None,
                    help="dir of concatenated pairs; right half is the target")
    ap.add_argument("--channels", type=int, default=1, choices=[1, 3])
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--orient", default="left", choices=["left", "right"])
    ap.add_argument("--fid-weights", default=None,
                    help="InceptionV3 .npz from tools/import_inception_weights.py: FID over "
                         "pool3 features (a random export gives a structured proxy only)")
    args = ap.parse_args(argv)
    device = default_device()

    gen_names = _image_names(args.generated)
    if args.pairs:
        # generated files match pair files by stem (--raw-predictions keeps the sources' names)
        by_stem = {os.path.splitext(n)[0]: n for n in _image_names(args.pairs)}
        matched = [(g, by_stem[os.path.splitext(g)[0]])
                   for g in gen_names if os.path.splitext(g)[0] in by_stem]
        assert matched, "no generated files share a stem with --pairs files"
        gen_names = [g for g, _ in matched]
        cache = build_pix2pix_cache([os.path.join(args.pairs, p) for _, p in matched],
                                    img_size=args.img_size, channels=args.channels,
                                    orient=args.orient, train=False)
        tar = cache[:, 1].astype(np.float32) / 127.5 - 1.0
    else:
        assert args.target, "--target or --pairs required"
        tar = _load(args.target, _image_names(args.target), args.channels, args.img_size)
    gen = _load(args.generated, gen_names, args.channels, args.img_size)

    n = min(len(gen), len(tar))
    gen, tar = (torch.from_numpy(a[:n]).to(device) for a in (gen, tar))
    report = {
        "n_images": n,
        "l1": quality.l1(gen, tar),
        "ssim": quality.ssim(gen, tar),
        "psnr_db": quality.psnr(gen, tar),
        "frechet_proxy": quality.frechet_distance(quality.random_features(gen),
                                                  quality.random_features(tar)),
    }
    if args.fid_weights:
        model = load_params(args.fid_weights).to(device)
        report["fid"] = quality.frechet_distance(extract_features(model, gen),
                                                 extract_features(model, tar))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
