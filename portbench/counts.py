"""What the work of a step is, from the configuration's shapes alone: the
model FLOPs that ``step_mfu_pct`` divides by the chip's peak, and the bytes
and operations of the operations that the kernels S (the stem conv), K1 and
K2 (the instance norm's forward and backward) carry out, whose bound a
``*_roofline`` metric divides by the kernels' time. None of it
asks the program what it launches, so a reading stays the same work
whatever implements it.

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


def _macs(convs) -> tuple[int, int]:
    """(all MACs, the stem's) per image."""
    return sum(m for m, _ in convs), sum(m for m, stem in convs if stem)


def step_flops(config: dict, training: bool, bx: int, by: int = 0) -> float:
    """Model FLOPs of one step of bx rows (CycleGAN: bx X and by Y rows)."""
    g, gs = _macs(unet_convs(config))
    d, ds = _macs(patchgan_convs(config))
    if config["model"] == "pix2pix":
        if not training:
            return 2.0 * bx * (g + 2 * d)
        # G: fwd, wgrad, dgrad but the stem's (x needs none); D(x, y): the
        # same; D(x, fake): fwd, dgrad to G (the stem's too), wgrad and
        # dgrad but the stem's in D's group
        return 2.0 * bx * ((3 * g - gs) + (3 * d - ds) + (4 * d - ds))
    rows = bx + by
    if not training:
        return 2.0 * (3 * rows * g + 2 * rows * d)
    # six generator applications of 3·rows rows in all, of which F(fake_y)
    # and G(fake_x) take their stem's dgrad; D on real (rows) and on fake
    # (rows) images
    return 2.0 * (3 * rows * (3 * g - gs) + rows * gs + rows * (3 * d - ds)
                  + rows * (4 * d - ds))


def epoch_steps(config: dict, n_x: int, n_y: int = 0) -> list[tuple[int, int, int]]:
    """(count, bx, by) of an epoch's step shapes: its full batches, then its
    partial last batch (Pix2Pix: by 0; CycleGAN: the zip of the two domains,
    whose tail takes what each domain has left, up to a batch)."""
    b = config["batch_size"]
    n = n_x if config["model"] == "pix2pix" else min(n_x, n_y)
    full, tail = divmod(n, b)
    by = 0 if config["model"] == "pix2pix" else b
    steps = [(full, b, by)] if full else []
    if tail:
        steps.append((1, tail, 0) if config["model"] == "pix2pix"
                     else (1, min(b, n_x - full * b), min(b, n_y - full * b)))
    return steps


def norm_sites(config: dict) -> tuple[list, list]:
    """(H = W, C) of each norm of the U-Net and of the PatchGAN."""
    s, d = config["img_size"], depth(config)
    down = config["generator"]["down_filters"][:d]
    gen = [(s >> (i + 1), f) for i, f in enumerate(down)][1:]
    gen += [(s >> (d - 1 - i), f) for i, (f, _drop) in enumerate(_up_blocks(config))]
    return gen, [(s // 4, 128), (s // 8, 256), (s // 8 - 1, 512)]


def _norm_ops(sites, rows: int, dtype: str, backward: bool) -> list[tuple[float, float]]:
    e = DTYPE_BYTES[dtype]
    out = []
    for hw, c in sites:
        n = rows * hw * hw * c
        if backward:   # read x, dy, scale; write dx, dscale, doffset
            out.append((3 * n * e + 3 * c * 4, NORM_BWD_FLOPS * n))
        else:          # read x, scale, offset; write y
            out.append((2 * n * e + 2 * c * 4, NORM_FWD_FLOPS * n))
    return out


def norm_ops(config: dict, training: bool, bx: int, by: int, backward: bool) -> list:
    """(bytes, operations) of each instance norm of a CycleGAN step, forward
    (K1's work) or backward (K2's); none for batch-norm configurations."""
    if config["model"] != "cyclegan" or config["generator"]["norm"] != "instance":
        return []
    gen, disc = norm_sites(config)
    rows, dt = bx + by, config["dtype"]
    if not backward:
        return _norm_ops(gen, 3 * rows, dt, False) + _norm_ops(disc, 2 * rows, dt, False)
    if not training:
        return []
    # the generators' walk: every generator application and D on the fakes;
    # the discriminators' walk: D on real and on fake images
    return _norm_ops(gen, 3 * rows, dt, True) + _norm_ops(disc, rows + 2 * rows, dt, True)


def stem_ops(config: dict, training: bool, bx: int, by: int = 0) -> list[tuple[float, float]]:
    """(bytes, operations) of each stem conv + LeakyReLU of a step (S's work):
    4x4 stride 2 to 64 filters, per network application."""
    s, c, e = config["img_size"], config["channels"], DTYPE_BYTES[config["dtype"]]

    def stem(rows, cin):
        out = rows * (s // 2) ** 2 * 64
        return ((rows * s * s * cin + 64 * cin * 16 + out) * e, 2.0 * out * 16 * cin)

    if config["model"] == "pix2pix":
        return [stem(bx, c), stem(bx, 2 * c), stem(bx, 2 * c)]
    return [stem(r, c) for r in (bx, bx, by, by, bx, by)] + [stem(r, c) for r in (bx, by, by, bx)]
