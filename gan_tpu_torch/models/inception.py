"""InceptionV3 pool3 feature extractor, the FID backbone (counterpart of
gan_tpu/models/inception.py).

The architecture is keras' ``InceptionV3(include_top=False)``: 94 blocks of a
bias-free conv, batch norm in inference mode (scale=False, ε 1e-3) and ReLU,
consumed in keras' call order, which is the order of the ``.npz`` that
``tools/import_inception_weights.py`` and gan_tpu's ``save_params`` write
(keys ``{w,beta,mean,var}_{i}``, ``w`` HWIO): one weights file serves both
packages. ``_graph`` states the network once; building the module runs it on
channel counts to size the blocks, and the forward runs it on tensors, so
chained calls ``cb(cb(x))`` consume their blocks innermost first, as in
gan_tpu. The 3×3 stride-1 'SAME' average pool leaves the padding out of its
divisor (``count_include_pad=False``); the max pools are 3×3 stride 2 VALID.

``extract_features`` runs the module in fp32 with TF32 off (cuDNN's convs
default to TF32 on the card), so the features, and FID, are the same on the
card and on the CPU. Each image is independent (batch norm in inference
mode), so the chunk size does not change the result and the last chunk is
not padded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_tpu_torch.device import no_tf32

BN_EPS = 1e-3
N_CONV_BN = 94   # (conv, batch norm) blocks in keras' call order
SIZE = 299       # the extractor's input size
_KEYS = ("w", "beta", "mean", "var")


def _graph(x, cb, max_pool, avg_pool, cat):
    """InceptionV3 up to pool3 (keras/src/applications/inception_v3.py).
    ``cb(x, c_out, k, stride=1, padding="same")``: one conv+BN+ReLU block,
    ``k`` an int or (kh, kw)."""
    x = cb(x, 32, 3, 2, "valid")
    x = cb(x, 32, 3, 1, "valid")
    x = cb(x, 64, 3)
    x = max_pool(x)
    x = cb(x, 80, 1, 1, "valid")
    x = cb(x, 192, 3, 1, "valid")
    x = max_pool(x)

    for pool_c in (32, 64, 64):                        # mixed 0-2: 35²
        b1 = cb(x, 64, 1)
        b5 = cb(cb(x, 48, 1), 64, 5)
        b3d = cb(cb(cb(x, 64, 1), 96, 3), 96, 3)
        bp = cb(avg_pool(x), pool_c, 1)
        x = cat(b1, b5, b3d, bp)

    b3 = cb(x, 384, 3, 2, "valid")                     # mixed 3: down to 17²
    b3d = cb(cb(cb(x, 64, 1), 96, 3), 96, 3, 2, "valid")
    x = cat(b3, b3d, max_pool(x))

    for c in (128, 160, 160, 192):                     # mixed 4-7: 17²
        b1 = cb(x, 192, 1)
        b7 = cb(cb(cb(x, c, 1), c, (1, 7)), 192, (7, 1))
        b7d = cb(cb(cb(cb(cb(x, c, 1), c, (7, 1)), c, (1, 7)), c, (7, 1)), 192, (1, 7))
        bp = cb(avg_pool(x), 192, 1)
        x = cat(b1, b7, b7d, bp)

    b3 = cb(cb(x, 192, 1), 320, 3, 2, "valid")         # mixed 8: down to 8²
    b7x3 = cb(cb(cb(cb(x, 192, 1), 192, (1, 7)), 192, (7, 1)), 192, 3, 2, "valid")
    x = cat(b3, b7x3, max_pool(x))

    for _ in range(2):                                 # mixed 9-10: 8², forked 1×3 / 3×1
        b1 = cb(x, 320, 1)
        b3 = cb(x, 384, 1)
        b3 = cat(cb(b3, 384, (1, 3)), cb(b3, 384, (3, 1)))
        b3d = cb(cb(x, 448, 1), 384, 3)
        b3d = cat(cb(b3d, 384, (1, 3)), cb(b3d, 384, (3, 1)))
        bp = cb(avg_pool(x), 192, 1)
        x = cat(b1, b3, b3d, bp)
    return x


class ConvBN(nn.Module):
    """Bias-free conv (OIHW), batch norm in inference mode without a scale,
    ReLU. Buffers only: the extractor is never trained."""

    def __init__(self, c_in: int, c_out: int, k, stride: int, padding: str):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        assert padding == "valid" or stride == 1, "'same' only at stride 1"
        self.stride = stride
        self.padding = (kh // 2, kw // 2) if padding == "same" else (0, 0)
        self.register_buffer("w", torch.zeros(c_out, c_in, kh, kw))
        for name in ("beta", "mean"):
            self.register_buffer(name, torch.zeros(c_out))
        self.register_buffer("var", torch.ones(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.w, stride=self.stride, padding=self.padding)
        inv = torch.rsqrt(self.var + BN_EPS)[:, None, None]
        return torch.relu((x - self.mean[:, None, None]) * inv + self.beta[:, None, None])


class InceptionV3(nn.Module):
    """(N, H, W, 3) NHWC in [-1, 1], H, W ≥ 75 (299 for FID) -> (N, 2048)
    pool3 features."""

    def __init__(self):
        super().__init__()
        specs = []

        def cb(c_in, c_out, k, stride=1, padding="same"):
            specs.append((c_in, c_out, k, stride, padding))
            return c_out

        out = _graph(3, cb, lambda c: c, lambda c: c, lambda *cs: sum(cs))
        assert len(specs) == N_CONV_BN and out == 2048
        self.blocks = nn.ModuleList(ConvBN(*s) for s in specs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        it = iter(self.blocks)
        x = _graph(x.permute(0, 3, 1, 2), lambda h, *spec: next(it)(h),
                   lambda h: F.max_pool2d(h, 3, 2),
                   lambda h: F.avg_pool2d(h, 3, 1, padding=1, count_include_pad=False),
                   lambda *hs: torch.cat(hs, dim=1))
        assert next(it, None) is None
        return x.mean(dim=(2, 3))

    def load_params(self, params: list) -> "InceptionV3":
        """gan_tpu's params: ``N_CONV_BN`` dicts {w (HWIO), beta, mean, var}."""
        assert len(params) == N_CONV_BN, len(params)
        with torch.no_grad():
            for block, p in zip(self.blocks, params):
                for k in _KEYS:
                    a = np.asarray(p[k], np.float32)
                    t = torch.from_numpy(a.transpose(3, 2, 0, 1) if k == "w" else a)
                    getattr(block, k).copy_(t)
        return self


def load_params(path: str) -> InceptionV3:
    """The module with the weights of an ``.npz`` in gan_tpu's
    ``save_params`` layout, on the CPU."""
    with np.load(path) as z:
        params = [{k: z[f"{k}_{i}"] for k in _KEYS} for i in range(N_CONV_BN)]
    return InceptionV3().load_params(params)


def save_params(params: list, path: str) -> None:
    """gan_tpu's ``save_params``: ``{w,beta,mean,var}_{i}`` arrays in one ``.npz``."""
    np.savez(path, **{f"{k}_{i}": np.asarray(v) for i, p in enumerate(params)
                      for k, v in p.items()})


def random_params(seed: int) -> list:
    """Seeded random weights in gan_tpu's layout (HWIO ``w``), the stand-in
    for pretrained ones: He-scaled convs, small BN shifts and means, BN
    variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    params = []
    for block in InceptionV3().blocks:
        c_out, c_in, kh, kw = block.w.shape
        params.append({
            "w": rng.normal(0, (2.0 / (kh * kw * c_in)) ** 0.5,
                            (kh, kw, c_in, c_out)).astype(np.float32),
            "beta": rng.normal(0, 0.1, c_out).astype(np.float32),
            "mean": rng.normal(0, 0.1, c_out).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c_out).astype(np.float32)})
    return params


def prepare_images(x, device=None) -> torch.Tensor:
    """Generated images ((N, H, W, C) in [-1, 1], C ∈ {1, 3}; numpy or a
    tensor) -> the extractor's (N, 299, 299, 3) fp32 on ``device``: gray
    tiles to RGB, then a half-pixel bilinear resize as gan_tpu's
    ``jax.image.resize(method="bilinear")``, antialiased (a widened
    triangle) where it shrinks."""
    x = torch.as_tensor(x).to(device, torch.float32)
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    h, w = x.shape[1:3]
    if (h, w) == (SIZE, SIZE):
        return x.contiguous()
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(SIZE, SIZE), mode="bilinear",
                      align_corners=False, antialias=h > SIZE or w > SIZE)
    return y.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def extract_features(model: InceptionV3, images, batch: int = 64) -> np.ndarray:
    """pool3 features (N, 2048) of [-1, 1] images (any H, W, C ∈ {1, 3}),
    ``batch`` at a time on the module's device, fp32 with TF32 off."""
    device = model.blocks[0].w.device
    outs = []
    with no_tf32():
        for lo in range(0, len(images), batch):
            outs.append(model(prepare_images(images[lo:lo + batch], device)).cpu())
    return torch.cat(outs).numpy()
