"""What the work of a step is, from the configuration's shapes alone: the
model FLOPs that ``step_mfu_pct`` divides by the chip's peak, and the bytes
and operations of the operations that the kernels S (the stem conv), K1 and
K2 (the instance norm's forward and backward) carry out, whose bound a
``*_roofline`` metric divides by the kernels' time. None of it
asks the program what it launches, so a reading stays the same work
whatever implements it. Each model counts its own step in
``portbench/models/<model>.py``; ``step_flops``, ``epoch_steps``,
``norm_ops`` and ``stem_ops`` here hand the configuration to its model,
and the rest are the parts the models count with.

Model FLOPs are 2 · MAC of every conv and transposed conv of a step,
forward and backward (dgrad and wgrad), with no dgrad where the input needs
no gradient, and no recomputation. Each network's gradient is taken on its
own objective (one ``autograd.grad`` per gradient group, the reference's one
tape per network), so a discriminator applied to a fake image carries two
dgrads: one to the generators, one inside its own group.

A roofline's bound is, per operation, the larger of its bytes over the
device memory's bandwidth and its operations over the peak for the compute
dtype, each input read once and each output written once (``bound_s``,
chip_smoke.py's ``bound_ms`` arithmetic).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}     # dense; fp32 outside the tensor cores
DTYPE_BYTES = {"bf16": 2, "fp32": 4}
NORM_FWD_FLOPS, NORM_BWD_FLOPS = 7, 11           # per element: moments, normalise, affine


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def depth(config: dict) -> int:
    return min(config["generator"]["depth"], config["img_size"].bit_length() - 1)


def _up_blocks(config: dict) -> list:
    ups = config["generator"]["up_blocks"]
    return ups[len(ups) - (depth(config) - 1):]


def unet_convs(config: dict) -> list[tuple[int, bool]]:
    """(MACs per image, is the stem) of each conv of the U-Net, in call order."""
    s, c, d = config["img_size"], config["channels"], depth(config)
    down = config["generator"]["down_filters"][:d]
    convs, cin = [], c
    for i, f in enumerate(down):
        convs.append(((s >> (i + 1)) ** 2 * f * cin * 16, i == 0))
        cin = f
    skips = down[:-1][::-1]
    for i, (f, _drop) in enumerate(_up_blocks(config)):
        convs.append(((s >> (d - i)) ** 2 * cin * f * 16, False))   # transposed: per input pixel
        cin = f + skips[i]
    convs.append(((s // 2) ** 2 * cin * c * 16, False))
    return convs


def patchgan_convs(config: dict) -> list[tuple[int, bool]]:
    s = config["img_size"]
    cin = config["channels"] * (2 if config["discriminator"]["conditional"] else 1)
    return [((s // 2) ** 2 * 64 * cin * 16, True), ((s // 4) ** 2 * 128 * 64 * 16, False),
            ((s // 8) ** 2 * 256 * 128 * 16, False), ((s // 8 - 1) ** 2 * 512 * 256 * 16, False),
            ((s // 8 - 2) ** 2 * 512 * 16, False)]


def macs(convs) -> tuple[int, int]:
    """(all MACs, the stem's) per image."""
    return sum(m for m, _ in convs), sum(m for m, stem in convs if stem)


def norm_sites(config: dict) -> tuple[list, list]:
    """(H = W, C) of each norm of the U-Net and of the PatchGAN."""
    s, d = config["img_size"], depth(config)
    down = config["generator"]["down_filters"][:d]
    gen = [(s >> (i + 1), f) for i, f in enumerate(down)][1:]
    gen += [(s >> (d - 1 - i), f) for i, (f, _drop) in enumerate(_up_blocks(config))]
    return gen, [(s // 4, 128), (s // 8, 256), (s // 8 - 1, 512)]


def site_norm_ops(sites, rows: int, dtype: str, backward: bool) -> list[tuple[float, float]]:
    """(bytes, operations) of an instance norm over ``rows`` images at each
    (H = W, C) site, forward or backward."""
    e = DTYPE_BYTES[dtype]
    out = []
    for hw, c in sites:
        n = rows * hw * hw * c
        if backward:   # read x, dy, scale; write dx, dscale, doffset
            out.append((3 * n * e + 3 * c * 4, NORM_BWD_FLOPS * n))
        else:          # read x, scale, offset; write y
            out.append((2 * n * e + 2 * c * 4, NORM_FWD_FLOPS * n))
    return out


def stem_op(config: dict, rows: int, cin: int) -> tuple[float, float]:
    """(bytes, operations) of one stem conv + LeakyReLU application (S's work):
    4x4 stride 2 to 64 filters over ``rows`` square images of ``cin``
    channels."""
    s, e = config["img_size"], DTYPE_BYTES[config["dtype"]]
    out = rows * (s // 2) ** 2 * 64
    return ((rows * s * s * cin + 64 * cin * 16 + out) * e, 2.0 * out * 16 * cin)


def _model(config: dict):
    from portbench import models
    return models.get(config["model"])


def step_flops(config: dict, training: bool, bx: int, by: int = 0) -> float:
    """Model FLOPs of one step of bx rows (two-domain models: bx X and by Y rows)."""
    return _model(config).step_flops(config, training, bx, by)


def epoch_steps(config: dict, n_x: int, n_y: int = 0) -> list[tuple[int, int, int]]:
    """(count, bx, by) of an epoch's step shapes: its full batches, then its
    partial last batch."""
    return _model(config).epoch_steps(config, n_x, n_y)


def norm_ops(config: dict, training: bool, bx: int, by: int, backward: bool) -> list:
    """(bytes, operations) of each instance norm of a step, forward (K1's
    work) or backward (K2's); [] where the model runs no instance norm."""
    return _model(config).norm_ops(config, training, bx, by, backward)


def stem_ops(config: dict, training: bool, bx: int, by: int = 0) -> list[tuple[float, float]]:
    """(bytes, operations) of each stem conv + LeakyReLU of a step (S's work)."""
    return _model(config).stem_ops(config, training, bx, by)
