"""gan_tpu_torch's pix2pixHD against the plain reference
(``tests/pix2pixhd_reference.py``, NVIDIA's equations in fp32 NCHW), on the
CPU in fp32 from the same weights, rows and flips, at ngf 8, 2
downsamplings, 2 residual blocks, 64x32 (the VGG's relu5_1 at 4x2), 35
labels and two discriminators: each network's forward, the five losses,
every trained parameter's gradient, and the parameters after two Adam
steps. Then the trainer's own parts: the VGG kept out of Adam, the groups
and the checkpoint, the epoch runner's shuffled order and flip draws, a
world above one rank refused.

Tolerances (fp32 on both sides; what differs is the order of summation):
the port runs its convs on NHWC (channels-last) tensors and its instance
norm as a two-pass over H·W per channel, the reference on NCHW tensors with
its own two-pass norm. A conv's output, a sum of a few hundred to a few
thousand products, agrees to about 1e-7 of its largest element, and each
instance norm divides that by a deviation, over a discriminator's few
dozen pixels a small one: the discriminators' outputs read up to 3e-6 of
their largest element, the generator's, through ten norms, up to 5e-5
where torch's CPU convs sum on 8 threads; every output takes 1e-4 of its
largest element (``OUT_RTOL``), the losses 1e-5 relative (``FWD``). Gradients sum over
every pixel and pass back through up to 13 convs: a discriminator's leaf
agrees to 1e-5 of its largest element (``GRAD_RTOL``), and so does the VGG
term's gradient on one fake image. The generator's gradient is the VGG
term's on two fakes that differ by rounding (1e-6): the L1's derivative,
sign(VGG(fake) − VGG(image)) / n, jumps where a unit is 0 on the image's
side (ReLU) and within rounding of 0 on the fake's, and the L1's gradient is
a sum of such unit steps, so k flipped units of n move it by about
k / √n: a few units of 2^18 read 1e-3 to 5e-3 of a leaf's norm, so the
generator's leaves take 2e-2 of their norm (``GEN_GRAD``). The biases
before an instance norm have a zero gradient in exact arithmetic: theirs
are rounding noise, held under 1e-5 of their network's largest gradient
element. Two Adam steps move a parameter by at most 2·lr; Adam divides each
gradient by its own root mean square, so an element whose gradient is
noise or flips sign steps by up to lr a step either way, and the second
step's discriminators see a fake of generators that differ by
``GEN_GRAD``: the change of each leaf over two steps agrees to 1e-2 of
its norm for the discriminators (1.1e-3 read) and ``GEN_GRAD`` for the
generator, and a noisy bias's
elements, each of which two noise-driven steps move by at most 2·lr on
either side, within 4·lr. In bf16 (``test_bf16_fails_the_tolerances``) every
discriminator leaf misses ``GRAD_RTOL`` and most generator leaves
``GEN_GRAD``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pix2pixhd_reference as ref
from gan_tpu_torch import losses
from gan_tpu_torch.config import Pix2PixHDConfig
from gan_tpu_torch.data import labels
from gan_tpu_torch.parallel import Replicas, single
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.pix2pixhd_trainer import Pix2PixHDTrainer
from torch_inputs import limit_threads

limit_threads()

H, W, B = 32, 64, 2
SMALL = dict(ngf=8, n_downsample_global=2, n_blocks_global=2, num_D=2, n_layers_D=3, ndf=64,
             label_nc=35)
FWD = dict(rtol=1e-5, atol=0.0)   # the losses
OUT_RTOL = 1e-4           # of an output's largest element
GRAD_RTOL = 1e-5          # of the leaf's largest element
GEN_GRAD = 2e-2           # of a generator leaf's norm: the VGG L1's flips
LR = 2e-4


def ref_config(**kw) -> dict:
    c = dict(SMALL, lambda_feat=10.0, no_instance=False, no_vgg_loss=False,
             no_ganFeat_loss=False)
    c.update(kw)
    return c


def make_trainer(dtype="fp32", **kw) -> Pix2PixHDTrainer:
    cfg = Pix2PixHDConfig(**dict(SMALL, **kw), batch_size=B, dtype=dtype, seed=5, load_size=W)
    cfg.validate()
    return Pix2PixHDTrainer(cfg)


def make_rows(n=B, seed=0) -> torch.Tensor:
    """(n, H, W, 6) uint8 rows: labels over 4x4 cells, instance ids over 8x8
    cells, uniform RGB."""
    g = torch.Generator().manual_seed(seed)

    def regions(size, high):
        coarse = torch.randint(0, high, (n, H // size, W // size), generator=g)
        return coarse.repeat_interleave(size, 1).repeat_interleave(size, 2)

    ids = regions(8, 1 << 16)
    rgb = torch.randint(0, 256, (n, H, W, 3), generator=g)
    return torch.cat([regions(4, 35)[..., None], (ids >> 8)[..., None], (ids & 255)[..., None],
                      rgb], -1).to(torch.uint8)


@pytest.fixture(scope="module")
def pair():
    """(trainer, reference networks) with equal weights: the port's seeded
    init, biases included, and a VGG whose weights keep its activations'
    scale (N(0, 2 / fan_in)), so the VGG term is no rounding error."""
    trainer = make_trainer()
    g = torch.Generator().manual_seed(9)
    vgg = {k: (torch.randn(v.shape, generator=g) * math.sqrt(2.0 / v[0].numel())
               if k.endswith("weight") else 0.1 * torch.randn(v.shape, generator=g))
           for k, v in trainer.vgg.state_dict().items()}
    trainer.vgg.load_state_dict(vgg)
    nets = ref.build(ref_config())
    for name, module in nets.items():
        module.load_state_dict(vgg if name == "vgg" else trainer.nets[name].state_dict())
    return trainer, nets


def ref_grads(nets, objectives, config):
    groups = (("gen",), tuple(f"disc_{i}" for i in range(config["num_D"])))
    out = {}
    for i, (group, objective) in enumerate(zip(groups, objectives)):
        params = [p for net in group for p in nets[net].parameters()]
        flat = torch.autograd.grad(objective, params, retain_graph=i == 0)
        for net in group:
            n = len(list(nets[net].parameters()))
            out[net], flat = list(flat[:n]), flat[n:]
    return out


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def assert_norm_close(got, want, rel, what):
    gap = float((got - want).norm()) / float(want.norm())
    assert gap <= rel, (what, gap)


def assert_grads(trainer, grads, expected):
    """Every trained leaf's gradient against the reference's, by the
    tolerances of the module docstring."""
    noisy = pre_norm_biases(trainer)
    for net in grads:
        names = [n for n, _ in trainer.nets[net].named_parameters()]
        top = max(float(e.abs().max()) for n, e in zip(names, expected[net]) if n.endswith("weight"))
        for n, got, exp in zip(names, grads[net], expected[net]):
            leaf = f"{net}.{n}"
            if leaf in noisy:
                assert float(got.abs().max()) <= GRAD_RTOL * top, leaf
            elif net == "gen":
                assert_norm_close(got, exp, GEN_GRAD, leaf)
            else:
                assert_scaled_close(got, exp, GRAD_RTOL, leaf)


def assert_scaled_close(got, want, rel, what=None):
    """|got − want| ≤ rel · max|want| elementwise."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=rel * scale + 1e-12, msg=what)


FLIP = torch.tensor([True, False])


def test_the_inputs_are_the_references():
    rows = make_rows()
    x, y = labels.hd_inputs(rows, FLIP, label_nc=35)
    rx, ry = ref.encode_input(rows, FLIP, ref_config())
    assert torch.equal(x, nhwc(rx)) and torch.equal(y, nhwc(ry))
    assert x.shape == (B, H, W, 36) and 0.05 < x[..., 35].mean() < 0.5


def test_each_networks_forward_is_the_references(pair):
    trainer, nets = pair
    rows = make_rows()
    x, y = trainer.inputs(rows, FLIP)
    rx, ry = ref.encode_input(rows, FLIP, ref_config())
    with torch.no_grad():
        fake = trainer.gen(x)
        assert_scaled_close(fake, nhwc(nets["gen"](rx)), OUT_RTOL, "gen")
        pair_in = torch.cat([x, fake], -1)
        for i, d in enumerate(trainer.discs):
            got, want = d(pair_in), nets[f"disc_{i}"](pair_in.permute(0, 3, 1, 2))
            assert len(got) == len(want) == 5
            for k, (a, b) in enumerate(zip(got, want)):
                assert_scaled_close(a, nhwc(b), OUT_RTOL, f"disc_{i} layer {k}")
            pair_in = torch.nn.functional.avg_pool2d(
                pair_in.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=False).permute(0, 2, 3, 1)
        taps, want = trainer.vgg(y), nets["vgg"](ry)
        assert [t.shape[1:3] for t in taps] == [(32, 64), (16, 32), (8, 16), (4, 8), (2, 4)]
        for k, (a, b) in enumerate(zip(taps, want)):
            assert_scaled_close(a, nhwc(b), OUT_RTOL, f"vgg tap {k}")


def test_the_losses_and_every_gradient_are_the_references(pair):
    trainer, nets = pair
    rows = make_rows(seed=1)
    x, y = trainer.inputs(rows, FLIP)
    grads, losses = trainer.gradients(x, y)
    objectives, want = ref.objectives(ref_config(), nets, *ref.encode_input(rows, FLIP,
                                                                          ref_config()))
    torch.testing.assert_close(losses, want.detach(), **FWD)
    assert (losses > 0).all()
    expected = ref_grads(nets, objectives, ref_config())
    assert set(grads) == {"gen", "disc_0", "disc_1"}
    for net in grads:
        assert [n for n, _ in nets[net].named_parameters()] == \
            [n for n, _ in trainer.nets[net].named_parameters()]
    assert_grads(trainer, grads, expected)


def test_the_vgg_terms_gradient_on_one_fake_is_the_references(pair):
    trainer, nets = pair
    rows = make_rows(seed=1)
    x, y = trainer.inputs(rows, FLIP)
    with torch.no_grad():
        fake = trainer.gen(x)
    mine = fake.clone().requires_grad_()
    theirs = fake.permute(0, 3, 1, 2).contiguous().requires_grad_()
    got, = torch.autograd.grad(losses.vgg_loss(trainer.vgg(mine), trainer.vgg(y), ref.VGG_WEIGHTS,
                                               lam=10.0), mine)
    taps = nets["vgg"](theirs), nets["vgg"](y.permute(0, 3, 1, 2))
    want, = torch.autograd.grad(sum(w * F.l1_loss(a, b.detach()) * 10.0
                                    for w, a, b in zip(ref.VGG_WEIGHTS, *taps)), theirs)
    assert_scaled_close(got, nhwc(want), GRAD_RTOL)


def pre_norm_biases(trainer) -> set:
    """The biases of convs that feed an instance norm: zero gradient in exact arithmetic."""
    g = trainer.config.n_downsample_global
    gen = (["stem"] + [f"down_{i}" for i in range(g)] + [f"up_{i}" for i in range(g)]
           + [f"block_{j}.conv_{k}" for j in range(trainer.config.n_blocks_global)
              for k in (0, 1)])
    disc = [f"layer_{k}" for k in range(1, trainer.config.n_layers_D + 1)]
    return ({f"gen.{n}.bias" for n in gen}
            | {f"{d}.{n}.bias" for d in ("disc_0", "disc_1") for n in disc})


def test_two_adam_steps_are_the_references():
    trainer = make_trainer()
    nets = ref.build(ref_config())
    for name, module in nets.items():
        module.load_state_dict((trainer.vgg if name == "vgg" else trainer.nets[name]).state_dict())
    trained = ("gen", "disc_0", "disc_1")
    start_params = {n: {k: v.clone() for k, v in trainer.nets[n].state_dict().items()}
                    for n in trained}
    opts = {n: ref.Adam(nets[n].parameters(), LR, (0.5, 0.999), 1e-8) for n in trained}
    for step in range(2):
        rows = make_rows(seed=10 + step)
        trainer.train_step(*trainer.inputs(rows, FLIP))
        objectives, _ = ref.objectives(ref_config(), nets, *ref.encode_input(rows, FLIP,
                                                                           ref_config()))
        grads = ref_grads(nets, objectives, ref_config())
        for n in trained:
            opts[n].step(grads[n])
    noisy = pre_norm_biases(trainer)
    for n in trained:
        for (leaf, got), want in zip(trainer.nets[n].named_parameters(), nets[n].parameters()):
            start = start_params[n][leaf]
            if f"{n}.{leaf}" in noisy:
                torch.testing.assert_close(got.detach(), want.detach(), rtol=0, atol=4 * LR,
                                           msg=f"{n}.{leaf}")
            else:
                assert_norm_close(got.detach() - start, want.detach() - start,
                                  GEN_GRAD if n == "gen" else 1e-2, f"{n}.{leaf}")
    for name, t in trainer.vgg.state_dict().items():   # frozen
        assert torch.equal(t, nets["vgg"].state_dict()[name])


def test_bf16_fails_the_tolerances(pair):
    """The same step computed in bf16 (fp32 parameters) misses the fp32
    tolerances: the gradients by far more than GRAD_RTOL."""
    trainer, nets = pair
    low = make_trainer("bf16")
    low.load_state({"params": {**trainer.state()["params"], "vgg": trainer.vgg.state_dict()}})
    rows = make_rows(seed=1)
    grads, _ = low.gradients(*low.inputs(rows, FLIP))
    objectives, _ = ref.objectives(ref_config(), nets, *ref.encode_input(rows, FLIP,
                                                                       ref_config()))
    expected = ref_grads(nets, objectives, ref_config())
    with pytest.raises(AssertionError):
        assert_grads(trainer, grads, expected)
    noisy = pre_norm_biases(trainer)
    disc = [(g, e) for net in ("disc_0", "disc_1")
            for (n, _), g, e in zip(trainer.nets[net].named_parameters(), grads[net],
                                    expected[net]) if f"{net}.{n}" not in noisy]
    assert all(float((g - e).abs().max()) > GRAD_RTOL * float(e.abs().max()) for g, e in disc)
    gen = [float((g - e).norm()) / float(e.norm())
           for (n, _), g, e in zip(trainer.gen.named_parameters(), grads["gen"], expected["gen"])
           if f"gen.{n}" not in noisy]
    assert sum(gap > GEN_GRAD for gap in gen) > len(gen) / 2


def test_the_references_norm_is_instance_norm_whatever_the_layout():
    """The reference writes its instance norm out: it equals
    ``F.instance_norm``, and its gradient is the same whatever the memory
    layout of the gradient it is handed, where ``F.instance_norm``'s
    backward in this torch can read a channels-last gradient wrong."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 8, 6, 10, generator=g, dtype=torch.float64)
    up = torch.randn(1, 8, 6, 10, generator=g, dtype=torch.float64)
    torch.testing.assert_close(ref.norm(x), F.instance_norm(x, eps=ref.IN_EPS))
    grads = []
    for u in (up, up.contiguous(memory_format=torch.channels_last)):
        a = x.clone().requires_grad_()
        ref.norm(a).backward(u)
        grads.append(a.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-12)
    a = x.clone().requires_grad_()
    F.instance_norm(a, eps=ref.IN_EPS).backward(up)
    torch.testing.assert_close(grads[0], a.grad, rtol=0, atol=1e-12)


def test_the_vgg_takes_no_adam_and_no_checkpoint():
    trainer = make_trainer()
    assert set(trainer.nets) == set(trainer.opts) == {"gen", "disc_0", "disc_1"}
    assert trainer.groups == (("gen",), ("disc_0", "disc_1"))
    assert not any(p.requires_grad for p in trainer.vgg.parameters())
    state = trainer.state()
    assert set(state["params"]) == set(state["opt_states"]) == {"gen", "disc_0", "disc_1"}
    gen_params = sum(p.numel() for p in trainer.gen.parameters())
    assert gen_params == 8 * 36 * 49 + 8 + 16 * 8 * 9 + 16 + 32 * 16 * 9 + 32 + \
        4 * (32 * 32 * 9 + 32) + 32 * 16 * 9 + 16 + 16 * 8 * 9 + 8 + 3 * 8 * 49 + 3
    vgg = {k: v + 1 for k, v in trainer.vgg.state_dict().items()}
    trainer.load_state({"params": {**state["params"], "vgg": vgg}})
    assert all(torch.equal(trainer.vgg.state_dict()[k], v) for k, v in vgg.items())


def test_the_published_networks_have_the_published_sizes():
    from gan_tpu_torch.models.multiscale_d import NLayerDiscriminator
    from gan_tpu_torch.models.resnet_generator import GlobalGenerator
    from gan_tpu_torch.models.vgg import VGG19Trunk
    with torch.device("meta"):
        nets = ref.build(ref_config(ngf=64, n_downsample_global=4, n_blocks_global=9))
        port = {"gen": GlobalGenerator(36), "disc_0": NLayerDiscriminator(39),
                "disc_1": NLayerDiscriminator(39), "vgg": VGG19Trunk()}
    for n, m in nets.items():
        assert [(k, p.shape) for k, p in m.named_parameters()] == \
            [(k, p.shape) for k, p in port[n].named_parameters()], n
    sizes = {n: sum(p.numel() for p in m.parameters()) for n, m in nets.items()}
    assert sizes == {"gen": 182_546_755, "disc_0": 2_801_601, "disc_1": 2_801_601,
                     "vgg": 12_944_960}


def test_load_torchvision_takes_the_features_and_refuses_a_gap():
    trainer = make_trainer(no_vgg_loss=False)
    tv = {k: torch.full_like(v, 0.5) for k, v in trainer.vgg.state_dict().items()}
    tv["classifier.0.weight"] = torch.zeros(4, 4)   # ignored
    trainer.vgg.load_torchvision(tv)
    assert all(torch.equal(v, tv[k]) for k, v in trainer.vgg.state_dict().items())
    del tv["features.28.bias"]
    with pytest.raises(ValueError, match="features.28.bias"):
        trainer.vgg.load_torchvision(tv)


def test_no_vgg_and_no_feature_matching_zero_their_losses():
    trainer = make_trainer(no_vgg_loss=True, no_ganFeat_loss=True)
    assert trainer.vgg is None
    _grads, losses = trainer.gradients(*trainer.inputs(make_rows(), None))
    assert losses[1] == 0 and losses[2] == 0 and losses[0] > 0


def test_the_epoch_runs_the_shuffled_rows_with_the_keyed_flips():
    """A train pass through the runner equals eager steps over
    ``epoch_rng``'s permutation with each step's keyed flips; a val pass
    runs the rows in order without flips; 5 rows at batch 2 leave a tail."""
    rows = make_rows(5, seed=3)
    graph, eager = make_trainer(no_vgg_loss=True), make_trainer(no_vgg_loss=True)
    got = graph.run_epoch(rows, 1, training=True)
    perm = loop.epoch_rng(5, 1, 0).permutation(5)
    want = [eager._step(rows[torch.from_numpy(perm[s * B:(s + 1) * B])], 1, 0, s).detach()
            for s in range(3)]
    np.testing.assert_allclose(got, torch.stack(want).numpy(), rtol=1e-6)
    for n in graph.nets:
        for a, b in zip(graph.nets[n].parameters(), eager.nets[n].parameters()):
            assert torch.equal(a, b)
    val = graph.run_epoch(rows, 1, training=False)
    want = [eager.eval_step(*eager.inputs(rows[s * B:(s + 1) * B], None)) for s in range(3)]
    np.testing.assert_allclose(val, torch.stack(want).numpy(), rtol=1e-6)
    draws = graph._step_draws(1, 0, 2)
    assert draws.masks == [] and draws.jitter[0][0].shape == (B,)
    assert graph._step_draws(1, 1, 0).tensors() == []


def test_a_world_above_one_rank_is_refused():
    cfg = Pix2PixHDConfig(**SMALL, dtype="fp32")
    with pytest.raises(ValueError, match="one rank"):
        Pix2PixHDTrainer(cfg, Replicas(device=torch.device("cpu"), rank=0, size=2))
    assert single().size == 1


# ------------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with --noconftest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["reflection_pad", "conv_transpose2d", "avg_pool3_s2",
                                "max_pool2"])
def test_the_ops_gradients_on_the_card_are_the_cpus(card, op):
    """Each pix2pixHD op's input gradient in fp32 on the card equals the
    CPU's, at a discriminator's 39 channels over 64x128 (ATen's
    channels-last average pool with count_include_pad=False gives a wrong
    backward on the card, so ``avg_pool3_s2`` pools an NCHW copy)."""
    from gan_tpu_torch.models.vgg import max_pool2
    from gan_tpu_torch.ops import conv
    g = torch.Generator().manual_seed(7)
    x = torch.randn(1, 64, 128, 39, generator=g)
    w = 0.05 * torch.randn(39, 16, 3, 3, generator=g)
    fn = {"reflection_pad": lambda t: conv.reflection_pad(t, 3),
          "conv_transpose2d": lambda t: conv.conv_transpose2d(t, w.to(t.device)),
          "avg_pool3_s2": conv.avg_pool3_s2, "max_pool2": max_pool2}[op]
    grads = []
    with torch.backends.cudnn.flags(allow_tf32=False):
        for device in (torch.device("cpu"), card):
            t = x.to(device, copy=True).requires_grad_()
            y = fn(t)
            up = torch.randn(y.shape, generator=torch.Generator().manual_seed(8)).to(device)
            (y * up).sum().backward()
            grads.append(t.grad.cpu())
    assert_scaled_close(grads[1], grads[0], 1e-5, op)


@pytest.mark.cuda
def test_the_step_on_the_card_is_the_references(card):
    """The tiny configuration's step in fp32 with TF32 off on the card: the
    losses and gradients against the reference's, the CPU tests' tolerances."""
    with torch.backends.cudnn.flags(allow_tf32=False):
        cfg = Pix2PixHDConfig(**SMALL, batch_size=B, dtype="fp32", seed=5, load_size=W)
        trainer = Pix2PixHDTrainer(cfg, Replicas(device=card))
        nets = ref.build(ref_config())
        for name, module in nets.items():
            module.to(card).load_state_dict(
                (trainer.vgg if name == "vgg" else trainer.nets[name]).state_dict())
        rows, flip = make_rows(seed=1).to(card), FLIP.to(card)
        grads, got = trainer.gradients(*trainer.inputs(rows, flip))
        objectives, want = ref.objectives(ref_config(), nets,
                                          *ref.encode_input(rows, flip, ref_config()))
        torch.testing.assert_close(got, want.detach(), **FWD)
        expected = ref_grads(nets, objectives, ref_config())
        assert_grads(trainer, {n: [t.cpu() for t in v] for n, v in grads.items()},
                     {n: [t.cpu() for t in v] for n, v in expected.items()})
