"""pix2pixHD's training step in plain float32 PyTorch, written from NVIDIA's
equations (NVIDIA/pix2pixHD models/networks.py, models/pix2pixHD_model.py,
train.py; ``--netG global``), for the port's tests to hold
gan_tpu_torch's pix2pixHD against. It imports nothing of gan_tpu or
gan_tpu_torch. Callers keep TF32 off (``torch.backends.cuda.matmul`` and
``torch.backends.cudnn``) on a card.

Activations are NCHW, as NVIDIA's. The networks carry the port's parameter
names (``stem``, ``down_{i}``, ``block_{j}.conv_{0,1}``, ``up_{i}``,
``head``; ``layer_{k}``; ``features.N``, each ``.weight`` and ``.bias``)
and layouts, so one set of weights loads into both; nothing here
initialises a weight.

``q`` is applied to both operands of every convolution, and ``q.grad``,
where it has one, to every convolution's output before its bias: the
identity here, a rounding for a control.

Departures from NVIDIA's code, none of which changes a number:
  * the multiscale discriminator's networks are named by the scale they
    see (``disc_0`` full resolution), where NVIDIA's wrapper names the
    full-resolution one ``scale{num_D-1}``;
  * one Adam per network (``disc_0``, ``disc_1``) where NVIDIA has one over
    both discriminators' parameters: Adam is per parameter, so they step
    alike;
  * the gradients are taken as two ``autograd.grad`` calls, G's objective
    with respect to G's parameters and D's with respect to D's, both from
    one forward, before either network steps; NVIDIA steps G, then takes
    D's backward (whose graph holds no G parameter: the fake is detached);
  * the input's flip is a draw per row on the device, not PIL's per-pair
    flip on the host; the one-hot is ``scatter_`` as NVIDIA's, on fp32;
  * no learning-rate decay: the steps compared are the first ones;
  * the instance norm is written out (``norm``) where NVIDIA calls
    ``nn.InstanceNorm2d``, whose backward is wrong for a channels-last
    gradient in the torch this runs on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

IN_EPS = 1e-5
LEAKY_SLOPE = 0.2
VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256), (16, 256, 256), (19, 256, 512), (21, 512, 512),
             (23, 512, 512), (25, 512, 512), (28, 512, 512))
VGG_POOL_BEFORE = (5, 10, 19, 28)
VGG_TAPS = (0, 5, 10, 19, 28)   # relu1_1 ... relu5_1
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
LOSS_KEYS = ("G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake")


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Conv(nn.Module):
    """A conv's weight (OIHW, or (C_in, C_out, k, k) ``transposed``) and bias."""

    def __init__(self, c_in: int, c_out: int, k: int, transposed: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c_in, c_out, k, k) if transposed
                                               else (c_out, c_in, k, k)))
        self.bias = nn.Parameter(torch.empty(c_out))


def conv(x, m: Conv, q, *, stride: int = 1, padding: int = 0, transposed: bool = False):
    """``nn.Conv2d`` or ``nn.ConvTranspose2d(output_padding=1)`` of ``m``."""
    if transposed:
        y = F.conv_transpose2d(q(x), q(m.weight), stride=stride, padding=padding,
                               output_padding=1)
    else:
        y = F.conv2d(q(x), q(m.weight), stride=stride, padding=padding)
    if hasattr(q, "grad"):
        y = q.grad(y)
    return y + m.bias[None, :, None, None]


def norm(x):
    """``InstanceNorm2d(affine=False)``, its two-pass moments written out:
    ``F.instance_norm``'s backward is wrong where its output's gradient
    arrives in channels-last memory (torch 2.13 on the CPU; a tensor's layout
    is an op's choice), and autograd through these ops is right whatever the
    layout."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + IN_EPS)


def reflect(x, p: int):
    return F.pad(x, (p, p, p, p), mode="reflect")


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_0, self.conv_1 = Conv(dim, dim, 3), Conv(dim, dim, 3)

    def forward(self, x, q):
        h = torch.relu(norm(conv(reflect(x, 1), self.conv_0, q)))
        return x + norm(conv(reflect(h, 1), self.conv_1, q))


class GlobalGenerator(nn.Module):
    def __init__(self, input_nc: int, output_nc: int, ngf: int, n_downsampling: int,
                 n_blocks: int):
        super().__init__()
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        self.stem = Conv(input_nc, ngf, 7)
        for i in range(n_downsampling):
            mult = 2 ** i
            self.add_module(f"down_{i}", Conv(ngf * mult, ngf * mult * 2, 3))
        for j in range(n_blocks):
            self.add_module(f"block_{j}", ResnetBlock(ngf * 2 ** n_downsampling))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up_{i}", Conv(ngf * mult, ngf * mult // 2, 3, transposed=True))
        self.head = Conv(ngf, output_nc, 7)

    def forward(self, x, q=identity):
        h = torch.relu(norm(conv(reflect(x, 3), self.stem, q)))
        for i in range(self.n_downsampling):
            h = torch.relu(norm(conv(h, getattr(self, f"down_{i}"), q, stride=2, padding=1)))
        for j in range(self.n_blocks):
            h = getattr(self, f"block_{j}")(h, q)
        for i in range(self.n_downsampling):
            h = torch.relu(norm(conv(h, getattr(self, f"up_{i}"), q, stride=2, padding=1,
                                     transposed=True)))
        return torch.tanh(conv(reflect(h, 3), self.head, q))


class NLayerDiscriminator(nn.Module):
    """With ``getIntermFeat``: every layer's output."""

    def __init__(self, input_nc: int, ndf: int, n_layers: int):
        super().__init__()
        self.n_layers = n_layers
        nf, c = ndf, input_nc
        self.layer_0 = Conv(c, nf, 4)
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"layer_{n}", Conv(nf_prev, nf, 4))
        self.add_module(f"layer_{n_layers + 1}", Conv(nf, 1, 4))

    def forward(self, x, q=identity):
        res = [F.leaky_relu(conv(x, self.layer_0, q, stride=2, padding=2), LEAKY_SLOPE)]
        for n in range(1, self.n_layers + 1):
            stride = 2 if n < self.n_layers else 1
            h = conv(res[-1], getattr(self, f"layer_{n}"), q, stride=stride, padding=2)
            res.append(F.leaky_relu(norm(h), LEAKY_SLOPE))
        res.append(conv(res[-1], getattr(self, f"layer_{self.n_layers + 1}"), q, padding=2))
        return res


class VGG19Trunk(nn.Module):
    """torchvision's ``vgg19().features`` to relu5_1, by its names."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict({str(i): Conv(c_in, c_out, 3)
                                       for i, c_in, c_out in VGG_CONVS})

    def forward(self, x, q=identity):
        taps, h = [], x
        for i, _c_in, _c_out in VGG_CONVS:
            if i in VGG_POOL_BEFORE:
                h = F.max_pool2d(h, 2)
            h = torch.relu(conv(h, self.features[str(i)], q, padding=1))
            if i in VGG_TAPS:
                taps.append(h)
        return taps


def build(config: dict) -> dict:
    """{"gen", "disc_0", ..., "vgg"}, parameters uninitialised; ``config``
    holds pix2pixHD's keys (label_nc, ngf, n_downsample_global,
    n_blocks_global, num_D, n_layers_D, ndf, no_instance)."""
    input_nc = config["label_nc"] + (0 if config["no_instance"] else 1)
    nets = {"gen": GlobalGenerator(input_nc, 3, config["ngf"], config["n_downsample_global"],
                                   config["n_blocks_global"])}
    for i in range(config["num_D"]):
        nets[f"disc_{i}"] = NLayerDiscriminator(input_nc + 3, config["ndf"], config["n_layers_D"])
    nets["vgg"] = VGG19Trunk()
    return nets


def get_edges(t: torch.Tensor) -> torch.Tensor:
    """NVIDIA's ``get_edges`` of (B, 1, H, W) instance ids, as uint8."""
    edge = torch.zeros(t.size(), dtype=torch.uint8, device=t.device)
    edge[:, :, :, 1:] = edge[:, :, :, 1:] | (t[:, :, :, 1:] != t[:, :, :, :-1])
    edge[:, :, :, :-1] = edge[:, :, :, :-1] | (t[:, :, :, 1:] != t[:, :, :, :-1])
    edge[:, :, 1:, :] = edge[:, :, 1:, :] | (t[:, :, 1:, :] != t[:, :, :-1, :])
    edge[:, :, :-1, :] = edge[:, :, :-1, :] | (t[:, :, 1:, :] != t[:, :, :-1, :])
    return edge


def one_hot(label: torch.Tensor, label_nc: int) -> torch.Tensor:
    """(B, 1, H, W) ids → (B, label_nc, H, W) fp32, NVIDIA's ``scatter_``."""
    size = (label.shape[0], label_nc, label.shape[2], label.shape[3])
    return torch.zeros(size, device=label.device).scatter_(1, label.long(), 1.0)


def encode_input(rows: torch.Tensor, flip, config: dict):
    """(input_label, real_image), NCHW fp32, of (B, H, W, 6) uint8 rows
    (label, instance id high and low byte, R, G, B), row b mirrored where
    ``flip[b]`` (None: none)."""
    rows = rows.clone()
    if flip is not None:
        for b in range(rows.shape[0]):
            if bool(flip[b]):
                rows[b] = rows[b].flip(1)
    label = rows[..., 0][:, None]
    input_label = one_hot(label, config["label_nc"])
    if not config["no_instance"]:
        inst = rows[..., 1].long() * 256 + rows[..., 2].long()
        input_label = torch.cat([input_label, get_edges(inst[:, None]).float()], dim=1)
    real = rows[..., 3:6].permute(0, 3, 1, 2).float() / 127.5 - 1.0
    return input_label, real


def multiscale(nets: dict, x, num_d: int, q):
    """``MultiscaleDiscriminator.forward``: disc_i on x pooled i times."""
    out = []
    for i in range(num_d):
        if i:
            x = F.avg_pool2d(x, 3, stride=2, padding=[1, 1], count_include_pad=False)
        out.append(nets[f"disc_{i}"](x, q))
    return out


def gan_loss(scales, real: bool):
    """``GANLoss(use_lsgan=True)``: Σ over scales of MSE(patch scores, 1 or 0)."""
    loss = 0
    for res in scales:
        pred = res[-1]
        loss = loss + F.mse_loss(pred, torch.full_like(pred, 1.0 if real else 0.0))
    return loss


def objectives(config: dict, nets: dict, input_label, real_image, q=identity):
    """((G's objective, D's objective), the five losses in LOSS_KEYS order)."""
    num_d, lam = config["num_D"], config["lambda_feat"]
    fake_image = nets["gen"](input_label, q)
    pred_fake_pool = multiscale(nets, torch.cat([input_label, fake_image.detach()], 1), num_d, q)
    loss_d_fake = gan_loss(pred_fake_pool, False)
    pred_real = multiscale(nets, torch.cat([input_label, real_image.detach()], 1), num_d, q)
    loss_d_real = gan_loss(pred_real, True)
    pred_fake = multiscale(nets, torch.cat([input_label, fake_image], 1), num_d, q)
    loss_g_gan = gan_loss(pred_fake, True)
    loss_g_feat = torch.zeros((), device=real_image.device)
    if not config["no_ganFeat_loss"]:
        feat_weights = 4.0 / (config["n_layers_D"] + 1)
        d_weights = 1.0 / num_d
        for i in range(num_d):
            for j in range(len(pred_fake[i]) - 1):
                loss_g_feat = loss_g_feat + d_weights * feat_weights * F.l1_loss(
                    pred_fake[i][j], pred_real[i][j].detach()) * lam
    loss_g_vgg = torch.zeros((), device=real_image.device)
    if not config["no_vgg_loss"]:
        x_vgg, y_vgg = nets["vgg"](fake_image, q), nets["vgg"](real_image, q)
        for w, a, b in zip(VGG_WEIGHTS, x_vgg, y_vgg):
            loss_g_vgg = loss_g_vgg + w * F.l1_loss(a, b.detach()) * lam
    losses = torch.stack([loss_g_gan, loss_g_feat, loss_g_vgg, loss_d_real, loss_d_fake])
    return (loss_g_gan + loss_g_feat + loss_g_vgg, (loss_d_fake + loss_d_real) * 0.5), losses


class Adam:
    """``torch.optim.Adam``'s update: p −= lr · m̂ / (√v̂ + ε)."""

    def __init__(self, params, lr: float, betas=(0.5, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
