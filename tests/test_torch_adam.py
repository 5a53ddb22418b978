"""Adam's update as one hand-written pass (``gan_tpu_torch/csrc/adam.cu``,
``ops/kernels.py:adam_step``).

On the CPU: the plain twin (``adam_update_plain``) against
``torch.optim.Adam``'s own CPU step, which the CPU path still takes; the
checks that refuse a row before any launch; the state the wrapper makes,
which has to be ``torch.optim.Adam``'s for ``state_dict``,
``checkpoint.py`` and ``transplant.adam_state``; and a loaded state whose
moments were saved in another layout, which ``load_state`` gives its
parameters' layout. On the card (``-m cuda``):
the kernel against ``torch.optim.Adam(capturable=True)`` and against its
twin at the parameter lists of both benchmark configurations, run twice
bit for bit, inside a CUDA graph bit for bit, and on the graph train step
of each trainer. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_adam.py
"""

import functools
import types

import numpy as np
import pytest
import torch

from gan_tpu_torch import transplant
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.data import augment
from gan_tpu_torch.models.patchgan import PatchGANDiscriminator
from gan_tpu_torch.models.unet import UNetGenerator
from gan_tpu_torch.ops import kernels
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.train.optim import adam
from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
from torch_inputs import limit_threads

limit_threads()

LR, STEPS = 2e-4, 5
EPS32 = torch.finfo(torch.float32).eps
# CPU shapes: a channels-last stem kernel, a channels-last conv kernel, a
# norm's channels, a scalar bias and a 3-D tensor whose length is odd
CPU_SHAPES = [(64, 1, 4, 4), (32, 16, 4, 4), (512,), (1,), (3, 5, 7)]


def _params(shapes, device="cpu", seed=1) -> list:
    """Seeded N(0, 0.02²) parameters, 4-D ones channels-last as the models keep them."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in shapes:
        p = (torch.randn(s, generator=g) * 0.02).to(device)
        if p.dim() == 4:
            p = p.contiguous(memory_format=torch.channels_last)
        out.append(p.requires_grad_())
    return out


def _grads(params, step: int) -> list:
    """Seeded gradients in each parameter's layout: N(0, 1e-3²), a fifth of
    them near zero (N(0, 1e-9²): Adam's sign noise, ROADMAP §3) and a
    twentieth exactly zero."""
    g = torch.Generator().manual_seed(100 + step)
    out = []
    for p in params:
        x = torch.randn(p.shape, generator=g)
        u = torch.rand(p.shape, generator=g)
        x = torch.where(u < 0.2, x * 1e-9, x * 1e-3).masked_fill(u > 0.95, 0.0)
        out.append(torch.empty_like(p, requires_grad=False).copy_(x))
    return out


# --------------------------------------------------------------------- CPU

def test_plain_twin_matches_torch_adam_on_the_cpu():
    """Five steps of the twin against ``torch.optim.Adam``'s CPU step from
    the same parameters and gradients. The moments take the same ops and
    agree bit for bit, and so do the steps. The parameters: the twin takes
    the bias corrections in fp32 from the fp32 step, as the kernel and the
    capturable form do, torch's CPU step in double, so 1 - beta_2^t differs
    by 1.3e-5 of itself at t = 1 (float32(0.999)) and each update by up to
    6.5e-6 of lr; and p rounds once a step. Hence, per element, at most 5
    steps × (1e-5 · lr + 2 ulp of |p|)."""
    want, got = _params(CPU_SHAPES), _params(CPU_SHAPES)
    opt_want, opt_got = adam(want, LR), adam(got, LR)
    for s in range(STEPS):
        grads = _grads(want, s)
        kernels.adam_step([opt_want], [grads])
        hyper, rows = kernels.adam_rows([opt_got], [grads])
        assert hyper == (LR, 0.5, 0.999, 1e-7)
        with torch.no_grad():
            kernels.adam_update_plain(rows, *hyper)
    for pw, pg in zip(want, got):
        sw, sg = opt_want.state[pw], opt_got.state[pg]
        assert torch.equal(sw["step"], sg["step"]) and float(sg["step"]) == STEPS
        assert torch.equal(sw["exp_avg"], sg["exp_avg"])
        assert torch.equal(sw["exp_avg_sq"], sg["exp_avg_sq"])
        tol = STEPS * (1e-5 * LR + 2 * EPS32 * pw.detach().abs())
        assert ((pw.detach() - pg.detach()).abs() <= tol).all(), tuple(pw.shape)


def _opt_with(p, g, **options):
    opt = torch.optim.Adam([p], lr=LR, betas=(0.5, 0.999), eps=1e-7, **options)
    return [opt], [[g]]


def _refusals():
    """(case, (optimizers, grads), error type) of rows the kernel does not take."""
    p = _params([(8, 4, 4, 4)])[0]          # channels-last
    dense = torch.zeros(8, 4, 4, 4)         # contiguous: another layout
    flat = torch.zeros(8)
    yield "grad strides", _opt_with(p, dense), ValueError
    yield "grad dtype", _opt_with(p, torch.zeros_like(p, dtype=torch.bfloat16)), TypeError
    yield "grad shape", _opt_with(p, torch.zeros(8, 4, 4, 3)), TypeError
    yield "weight decay", _opt_with(flat.clone().requires_grad_(), flat, weight_decay=0.1), \
        NotImplementedError
    yield "amsgrad", _opt_with(flat.clone().requires_grad_(), flat, amsgrad=True), \
        NotImplementedError
    yield "tensor lr", ([torch.optim.Adam([flat.clone().requires_grad_()], lr=torch.tensor(LR))],
                        [[flat]]), TypeError
    yield "parameter dtype", _opt_with(flat.double().requires_grad_(), flat.double()), TypeError
    yield "strided parameter", _opt_with(torch.zeros(8, 2)[:, 0].requires_grad_(),
                                         torch.zeros(8)), ValueError
    yield "extra gradient", ([adam([flat.clone().requires_grad_()], LR)], [[flat, flat]]), \
        ValueError
    yield "two learning rates", ([adam([flat.clone().requires_grad_()], LR),
                                  adam([flat.clone().requires_grad_()], 2 * LR)],
                                 [[flat], [flat]]), ValueError
    (opt,), grads = _opt_with(p, torch.zeros_like(p))
    opt.state[p].update(step=torch.zeros(()), exp_avg=torch.zeros_like(p),
                        exp_avg_sq=torch.zeros(8, 4, 4, 4))   # contiguous moment
    yield "moment strides", ([opt], grads), ValueError


REFUSALS = list(_refusals())


@pytest.mark.parametrize("case", range(len(REFUSALS)), ids=[r[0] for r in REFUSALS])
def test_adam_rows_refuse_what_the_kernel_does_not_take(case):
    """The checks run before any launch, on any device: a gradient or moment
    in another layout raises (nothing is copied), and so do other dtypes,
    shapes, a strided parameter, Adam options the kernel does not compute
    and optimizers that differ in lr, betas or eps."""
    _, (opts, grads), error = REFUSALS[case]
    with pytest.raises(error):
        kernels.adam_rows(opts, grads)


def test_adam_state_is_torch_adams_and_round_trips(tmp_path):
    """The state ``adam_rows`` makes has torch.optim.Adam's keys in its
    order, dtypes, devices, shapes and strides (the moments in the
    parameter's layout); it round-trips through ``state_dict``,
    ``CheckpointManager`` and ``load_state_dict``; and ``transplant.
    adam_state``'s contiguous moments take their parameter's layout from
    ``adam_relayout``, with their values, and then pass the kernel's
    checks."""
    ours, theirs = _params(CPU_SHAPES), _params(CPU_SHAPES)
    opt_ours, opt_theirs = adam(ours, LR), adam(theirs, LR)
    kernels.adam_rows([opt_ours], [_grads(ours, 0)])
    kernels.adam_step([opt_theirs], [_grads(theirs, 0)])
    for p, q in zip(ours, theirs):
        a, b = opt_ours.state[p], opt_theirs.state[q]
        assert list(a) == list(b) == ["step", "exp_avg", "exp_avg_sq"]
        for key in a:
            assert (a[key].dtype, a[key].device, a[key].shape, a[key].stride()) == \
                (b[key].dtype, b[key].device, b[key].shape, b[key].stride()), key
    CheckpointManager(str(tmp_path)).save(1, {"opt": opt_theirs.state_dict()})
    fresh = _params(CPU_SHAPES)
    opt_fresh = adam(fresh, LR)
    opt_fresh.load_state_dict(CheckpointManager(str(tmp_path)).restore()["opt"])
    for p, q in zip(fresh, theirs):
        for key, t in opt_theirs.state[q].items():
            got = opt_fresh.state[p][key]
            assert torch.equal(got, t) and got.stride() == t.stride(), key
    kernels.adam_rows([opt_fresh], [_grads(fresh, 1)])   # the loaded state passes the checks

    net = torch.nn.Module()
    net.w, net.b = (torch.nn.Parameter(p.detach()) for p in _params([(8, 3, 4, 4), (8,)]))
    tree = transplant.state_dict_to_params({k: v * 3 for k, v in net.state_dict().items()})
    opt_state = (types.SimpleNamespace(mu=tree, nu=tree, count=np.int32(3)), None)
    state = transplant.adam_state(opt_state, net)
    opt_net = adam(list(net.parameters()), LR)
    opt_net.load_state_dict({"state": state, "param_groups": opt_net.state_dict()["param_groups"]})
    assert kernels.adam_relayout(opt_net) == 2   # the channels-last kernel's two moments
    assert kernels.adam_relayout(opt_net) == 0
    for name, p in net.named_parameters():
        st = opt_net.state[p]
        assert st["exp_avg"].stride() == st["exp_avg_sq"].stride() == p.stride(), name
        assert torch.equal(st["exp_avg_sq"], p.detach() * 3), name
        assert float(st["step"]) == 3.0
    kernels.adam_rows([opt_net], [_grads(list(net.parameters()), 0)])


def test_load_state_gives_saved_moments_their_parameters_layout():
    """A trainer state whose Adam moments were saved contiguous beside
    channels-last conv kernels (as a run started from ``transplant``'s
    conversion saved them) loads through ``load_state`` with every moment
    in its parameter's layout and its values, and passes the kernel's
    checks."""
    cfg = parse_pix2pix(["--data", "d", "--output", "o", "--train", "--epochs", "1",
                         "--img-size", "32", "--batch-size", "2", "--dtype", "fp32"])
    src, dst = Pix2PixTrainer(cfg), Pix2PixTrainer(cfg)
    state = src.state()
    for name, opt in src.opts.items():
        params = kernels._params(opt)
        state["opt_states"][name]["state"] = {
            i: {"step": torch.tensor(2.0), "exp_avg": p.detach().contiguous() * 0.5,
                "exp_avg_sq": p.detach().contiguous() ** 2} for i, p in enumerate(params)}
    saved = sum(not p.is_contiguous() for ps in src.params.values() for p in ps)
    assert saved > 0   # channels-last kernels whose saved moments are contiguous
    dst.load_state(state)
    for name, opt in dst.opts.items():
        for p, q in zip(kernels._params(opt), src.params[name]):
            st = opt.state[p]
            layout = kernels._layout(p)   # strides over the dims longer than 1
            assert kernels._layout(st["exp_avg"]) == kernels._layout(st["exp_avg_sq"]) == layout
            assert torch.equal(st["exp_avg"], q.detach() * 0.5)
            assert torch.equal(st["exp_avg_sq"], q.detach() ** 2)
    kernels.adam_rows(dst.opts.values(), [_grads(dst.params[name], 0) for name in dst.opts])


# -------------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


@functools.cache
def _network_shapes(config: str) -> tuple:
    """((shape, channels-last) of every parameter) of each benchmark
    configuration's networks, in the trainers' order: pix2pix-512's
    batch-norm U-Net and conditional PatchGAN (57.17 M parameters),
    cyclegan-256's two instance-norm U-Nets and two PatchGANs (114.3 M)."""
    g = torch.Generator().manual_seed(0)
    norm = "batch" if config == "pix2pix" else "instance"
    nets = [UNetGenerator(1, 1, norm=norm, depth=8, generator=g),
            PatchGANDiscriminator(1, norm=norm, target=config == "pix2pix", generator=g)]
    nets = nets if config == "pix2pix" else nets[:1] * 2 + nets[1:] * 2
    return tuple(tuple((tuple(p.shape), p.dim() == 4 and not p.is_contiguous())
                       for p in net.parameters()) for net in nets)


def _card_params(config: str, device) -> list[list]:
    """Seeded parameters on the card at ``config``'s shapes and layouts, one list a network."""
    gen = torch.Generator(device=device).manual_seed(7)
    out = []
    for net in _network_shapes(config):
        ps = []
        for shape, channels_last in net:
            p = torch.randn(shape, generator=gen, device=device).mul_(0.02)
            ps.append(p.contiguous(memory_format=torch.channels_last) if channels_last else p)
        out.append(ps)
    return out


def _card_grads(params: list, step: int, device) -> list[list]:
    """As ``_grads``, drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(100 + step)
    out = []
    for ps in params:
        gs = []
        for p in ps:
            x = torch.randn(p.shape, generator=gen, device=device)
            u = torch.rand(p.shape, generator=gen, device=device)
            x = torch.where(u < 0.2, x * 1e-9, x * 1e-3).masked_fill(u > 0.95, 0.0)
            gs.append(torch.empty_like(p).copy_(x))
        out.append(gs)
    return out


def _ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in units in the last place of max(|a|, |b|)."""
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    return float(((a - b).abs() / ulp).max())


def _run(config: str, device, update, steps: int = STEPS):
    """``steps`` updates of ``config``'s parameters by ``update(optimizers,
    grads)`` from the seeded start: (optimizers, their parameters)."""
    params = _card_params(config, device)
    opts = [adam(ps, LR, capturable=True) for ps in params]
    for s in range(steps):
        with torch.no_grad():
            update(opts, _card_grads(params, s, device))
    torch.cuda.synchronize()
    return opts, params


def _torch_adam(opts, grads) -> None:
    for opt, gs in zip(opts, grads):
        for p, g in zip(opt.param_groups[0]["params"], gs):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)


def _twin(opts, grads) -> None:
    hyper, rows = kernels.adam_rows(opts, grads)
    kernels.adam_update_plain(rows, *hyper)


def _compare(got, want, what: str) -> None:
    """p, m and v of two runs of ``_run`` within ``ADAM_ULPS``, the steps equal."""
    (opts_g, params_g), (opts_w, params_w) = got, want
    worst = dict.fromkeys(("p", "exp_avg", "exp_avg_sq"), 0.0)
    for og, ow, pg, pw in zip(opts_g, opts_w, params_g, params_w):
        for a, b in zip(pg, pw):
            sa, sb = og.state[a], ow.state[b]
            assert torch.equal(sa["step"], sb["step"]) and float(sa["step"]) == STEPS
            worst["p"] = max(worst["p"], _ulps(a, b))
            for key in ("exp_avg", "exp_avg_sq"):
                worst[key] = max(worst[key], _ulps(sa[key], sb[key]))
    print(f"{what}: largest gaps in ulps {worst}")
    assert worst["p"] <= ADAM_ULPS["p"], worst
    assert max(worst["exp_avg"], worst["exp_avg_sq"]) <= ADAM_ULPS["moments"], worst


# The kernel against torch's capturable foreach form: the same fp32 terms in
# the same order, but torch's lerp and addcmul are contracted to fused
# multiply-adds by its compiler and the kernel's by hand, and torch's powf
# may be another build's: each may move a moment by one ulp a step, and an
# update a few ulps of itself, which can turn p's rounding: two ulps of p a
# step. Over 5 steps: the moments within 5 ulps, the parameters within 10.
# (On the H100 with torch 2.11 they agreed bit for bit.)
ADAM_ULPS = {"p": 10.0, "moments": 5.0}


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["pix2pix", "cyclegan"])
def test_kernel_matches_torch_capturable_adam(cuda_device, config):
    """Five steps at each benchmark configuration's parameter list (both
    networks of Pix2Pix, the four of CycleGAN), gradients with near-zero and
    zero entries: p, m and v within ``ADAM_ULPS``, the steps exactly; one
    update launch a step for Pix2Pix's 57 tensors and two for CycleGAN's
    114, counted by the wrapper and on the card."""
    host, card = kernels.LAUNCHES["adam_update"], kernels.card_launches()["adam_update"]
    got = _run(config, cuda_device, kernels.adam_step)
    per_step = {"pix2pix": 1, "cyclegan": 2}[config]
    assert per_step == kernels.adam_launches(sum(len(net) for net in _network_shapes(config)))
    assert kernels.LAUNCHES["adam_update"] - host == STEPS * per_step
    assert kernels.card_launches()["adam_update"] - card == STEPS * per_step
    want = _run(config, cuda_device, _torch_adam)
    _compare(got, want, f"{config}: kernel vs torch.optim.Adam(capturable=True)")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["pix2pix", "cyclegan"])
def test_kernel_matches_its_plain_twin(cuda_device, config):
    """The kernel against ``adam_update_plain`` on the card, which takes
    torch's kernels for the same terms: within ``ADAM_ULPS``."""
    got = _run(config, cuda_device, kernels.adam_step)
    want = _run(config, cuda_device, _twin)
    _compare(got, want, f"{config}: kernel vs plain twin")


@pytest.mark.cuda
def test_kernel_reruns_bit_for_bit_on_odd_tensors(cuda_device):
    """CycleGAN's list (two update launches) plus a tensor off the 16-byte
    grid and lengths that 4 does not divide: two runs equal bit for bit,
    and the scalar paths agree with the twin."""
    def run(update):
        buf = torch.randn(4100, generator=torch.Generator(device=cuda_device).manual_seed(3),
                          device=cuda_device).mul_(0.02)
        odd = [buf[1:4099], buf[:4098].clone(), buf[:37].clone()]   # 4 bytes off the grid
        params = _card_params("cyclegan", cuda_device) + [odd]
        opts = [adam(ps, LR, capturable=True) for ps in params]
        for s in range(3):
            update(opts, _card_grads(params, s, cuda_device))
        torch.cuda.synchronize()
        return [t.clone() for ps, o in zip(params, opts) for p in ps
                for t in (p, o.state[p]["exp_avg"], o.state[p]["exp_avg_sq"], o.state[p]["step"])]

    first, second = run(kernels.adam_step), run(kernels.adam_step)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    twin = run(_twin)
    assert max(_ulps(a, b) for a, b in zip(first[-12:], twin[-12:])) <= ADAM_ULPS["p"]


@pytest.mark.cuda
def test_graph_captured_update_equals_eager(cuda_device):
    """Pix2Pix's update captured in a CUDA graph and replayed three times
    (after one eager step, as the epoch runner warms up) equals four eager
    updates bit for bit, steps included."""
    eager_opts, eager_params = _run("pix2pix", cuda_device, kernels.adam_step, steps=4)
    params = _card_params("pix2pix", cuda_device)
    opts = [adam(ps, LR, capturable=True) for ps in params]
    grads = _card_grads(params, 0, cuda_device)
    kernels.adam_step(opts, grads)
    static = [[g.clone() for g in gs] for gs in grads]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        kernels.adam_step(opts, static)
    torch.cuda.current_stream().wait_stream(side)
    for s in range(1, 4):
        for buf, g in zip((b for gs in static for b in gs),
                          (g for gs in _card_grads(params, s, cuda_device) for g in gs)):
            buf.copy_(g)
        graph.replay()
    torch.cuda.synchronize()
    for ps, o, eps_, eo in zip(params, opts, eager_params, eager_opts):
        for p, q in zip(ps, eps_):
            assert torch.equal(p, q)
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(o.state[p][key], eo.state[q][key]), key


def _train_step_trainer(kind: str):
    common = ["--output", "o", "--train", "--epochs", "2", "--img-size", "64",
              "--batch-size", "2", "--dtype", "bf16"]
    if kind == "cyclegan":
        return CycleGANTrainer(parse_cyclegan(["--input-images", "x", "--target-images", "y",
                                               *common]))
    return Pix2PixTrainer(parse_pix2pix(["--data", "d", *common]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pix2pix", "cyclegan"])
def test_graph_train_step_runs_the_kernel(cuda_device, kind, monkeypatch):
    """A profiled epoch of two graph replays of each trainer's train step (no
    tail: 4 rows at batch 2) runs the kernel, as often as the card's own
    count says (``card_launches``), and none of torch's ``at::native``
    multi_tensor_apply kernels."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.delenv("GAN_TPU_PLATFORM", raising=False)
    monkeypatch.setenv("GAN_TPU_ALLOW_ANY_SIZE", "1")
    trainer = _train_step_trainer(kind)
    rng = np.random.default_rng(5)
    pad = 64 + augment.JITTER_PAD
    shape = (4, pad, pad, 1) if kind == "cyclegan" else (4, 2, pad, pad, 1)
    caches = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda_device)
              for _ in range(2 if kind == "cyclegan" else 1)]
    trainer.run_epoch(*caches, 0, training=True)   # the warm-up step and the capture
    replays = trainer.epoch_counts["replays"]
    before = kernels.card_launches()["adam_update"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_epoch(*caches, 1, training=True)
        torch.cuda.synchronize()
    assert trainer.epoch_counts["replays"] == replays + 2
    tensors = sum(len(ps) for ps in trainer.params.values())
    assert kernels.card_launches()["adam_update"] - before == 2 * kernels.adam_launches(tensors)
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    ours = [n for n in names if "adam_multi_tensor_apply_kernel" in n]
    torch_mta = [n for n in names if "multi_tensor_apply" in n and "at::native" in n]
    print(f"{kind}: {len(names)} kernel names; ours {ours}; torch's {torch_mta}")
    assert ours and not torch_mta
