"""The port's data parallelism on the CPU, against gan_tpu's shard_map steps.

The port's replicas are processes in a gloo group: two ranks, spawned by
tests/torch_dist_worker.py (jax-free), meet through a FileStore in the
test's tmp_path, with one torch thread each and timeouts on the group and
the join. gan_tpu runs on 2 of the 8 virtual CPU devices (tests/conftest.py).
The models are 32² depth-5 U-Nets, which have no dropout block, in fp32; a
spawn's ranks start while the parent compiles gan_tpu's side.

gan_tpu's batch norm takes the variance as E[x²] − mean² (its cross-replica
form too, with ``pmean`` of both moments), which cancels where a channel
holds few values (the 1×1 bottleneck holds 2-4 values per channel here);
tests/test_torch_pix2pix.py measured what that costs. So gan_tpu's blocks
get the two-pass variance, about the mean over every replica where its
``axis_name`` is set, and the tolerances measure the step.
"""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from PIL import Image

import gan_tpu.models.blocks as jax_blocks
from gan_tpu import config as jax_config
from gan_tpu.data import augment as jax_augment
from gan_tpu.ops import norm as jax_norm
from gan_tpu.parallel.mesh import DATA_AXIS, make_mesh, replicated_sharding
from gan_tpu.train import loop as jax_loop
from gan_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxCycleGAN
from gan_tpu.train.pix2pix_trainer import Pix2PixTrainer as JaxPix2Pix

import torch_dist_worker as worker
from gan_tpu_torch import parallel, pix2pix
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.parallel import mesh
from gan_tpu_torch.pix2pix import main as pix2pix_main
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
from gan_tpu_torch.transplant import networks_to_state_dicts
from torch_inputs import limit_threads

limit_threads()

# ----------------------------------------------------------------- the stripes
# (n, ndev, global batch, buffer): with and without a partial batch, stripes
# of unequal length, one device, and buffers that window each stripe
GRID = [(n, ndev, b, buf) for n, ndev, b, buf in (
    (1, 1, 1, 99999), (7, 1, 4, 3), (21, 2, 4, 99999), (21, 2, 8, 1), (21, 4, 8, 3),
    (35, 8, 16, 99999), (64, 8, 16, 5), (100, 4, 12, 7), (19, 2, 4, 99999), (13, 3, 6, 2),
    (40, 4, 4, 1), (9, 3, 3, 99999))]
_ids = [f"n{n}-w{w}-b{b}-buf{buf}" for n, w, b, buf in GRID]


@pytest.mark.parametrize("n,ndev,batch,buffer", GRID, ids=_ids)
def test_stripe_order_and_rows_match_gan_tpu(n, ndev, batch, buffer):
    """The same striping, and each rank's real rows (``stripe_rows``) are its
    block of it without the wrap padding."""
    order = loop.stripe_order(n, ndev)
    np.testing.assert_array_equal(order, jax_loop.stripe_order(n, ndev))
    l = len(order) // ndev
    for r in range(ndev):
        rows = parallel.stripe_rows(n, ndev, r)
        np.testing.assert_array_equal(rows, order[r * l:r * l + len(rows)])
        assert (rows % ndev == r).all() and len(rows) in (n // ndev, n // ndev + 1)


@pytest.mark.parametrize("n,ndev,batch,buffer", GRID, ids=_ids)
def test_epoch_plan_and_local_perm_match_gan_tpu(n, ndev, batch, buffer):
    steps, per_dev, rem = jax_loop.epoch_plan(n, batch, ndev)
    assert loop.epoch_plan(n, batch, ndev) == (steps, rem) and batch // ndev == per_dev
    np.testing.assert_array_equal(
        loop.local_perm(n, ndev=ndev, n_steps=steps, per_dev_batch=per_dev),
        jax_loop.local_perm(n, ndev=ndev, n_steps=steps, per_dev_batch=per_dev))
    if ndev > 1:   # a batch the devices do not divide
        with pytest.raises(AssertionError):
            jax_loop.epoch_plan(n, batch + 1, ndev)
        with pytest.raises(ValueError, match="must divide"):
            loop.epoch_plan(n, batch + 1, ndev)


@pytest.mark.parametrize("n,ndev,batch,buffer", GRID, ids=_ids)
def test_shuffled_stripe_perm_matches_gan_tpu(n, ndev, batch, buffer):
    """Equal draws from equal generators, and the leftover's shuffle after them."""
    steps = n // batch
    got = loop.shuffled_stripe_perm(n, ndev=ndev, n_steps=steps, per_dev_batch=batch // ndev,
                                    buffer_size=buffer, rng=np.random.default_rng(n + ndev))
    want = jax_loop.shuffled_stripe_perm(n, ndev=ndev, n_steps=steps,
                                         per_dev_batch=batch // ndev, buffer_size=buffer,
                                         rng=np.random.default_rng(n + ndev))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("num_devices,batch,present,fixed,want", [
    (2, 4, 8, None, 2), (1, 3, 1, None, 1), (0, 6, 4, None, 3), (0, 8, 8, None, 8),
    (0, 4, 2, 2, 2), (2, 2, 2, 2, 2), (0, 1, 1, None, 1)])
def test_world_size(num_devices, batch, present, fixed, want):
    assert parallel.world_size(num_devices, batch, present, fixed) == want


@pytest.mark.parametrize("num_devices,batch,present,fixed,message", [
    (3, 4, 8, None, "global batch of 4 does not divide over 3 replicas; the largest number "
                    "of replicas that divides it is 2"),
    (4, 6, 8, None, "divides it is 3"),
    (2, 1, 8, None, "divides it is 1"),
    (0, 6, 4, 4, "global batch of 6 does not divide over 4 replicas"),
    (3, 6, 2, None, "--num-devices 3 asks for more devices than the 2 present"),
    (2, 4, 4, 4, "--num-devices 2 differs from the world of 4 ranks")])
def test_world_size_refuses_what_it_cannot_give(num_devices, batch, present, fixed, message):
    """Nothing runs on fewer devices than asked (gan_tpu's ``_auto_devices``
    would shrink the mesh until it divides the batch)."""
    with pytest.raises(SystemExit, match=message):
        parallel.world_size(num_devices, batch, present, fixed)


def test_world_size_warns_where_it_takes_fewer_devices_than_present():
    with pytest.warns(UserWarning, match="3 of the 4 devices present train"):
        assert parallel.world_size(0, 6, 4) == 3


def test_cached_epoch_runs_eagerly_by_the_backend_rule():
    """A runner on the card whose group cannot be captured (gloo) runs every
    step eagerly, counts it, and captures nothing; only the rule decides
    (no CUDA call is made here: the step is on the CPU)."""
    assert not mesh.Replicas(backend="gloo").capturable
    assert mesh.Replicas(backend="nccl").capturable and mesh.Replicas().capturable
    counts = {"eager": 0, "captures": 0, "replays": 0, "eager_by_backend": 0}
    calls = []

    def step():
        calls.append(1)
        return torch.tensor([float(len(calls))])

    runner = loop.make_cached_epoch(step, torch.device("cuda"), counts=counts, capture=False)
    out = runner(3, lambda s: None)
    assert out.tolist() == [[1.0], [2.0], [3.0]] and runner.graph is None
    assert counts == {"eager": 3, "captures": 0, "replays": 0, "eager_by_backend": 3}


def test_replicas_without_a_group_change_nothing():
    """One replica: ``average`` hands the tensors back, ``broadcast`` the object."""
    one = parallel.single(torch.device("cpu"))
    t = [torch.arange(3.0), torch.ones(2, 2)]
    assert all(a is b for a, b in zip(one.average(t), t))
    assert one.broadcast({"a": 1}) == {"a": 1} and one.size == 1 and one.group is None


def _two_pass_batch_norm(x, gamma, beta, *, eps=jax_norm.BN_EPS, axis_name=None):
    """gan_tpu's batch_norm with the variance taken as E[(x − mean)²], each
    moment ``pmean``-ed where ``axis_name`` is set."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(0, 1, 2))
    if axis_name is not None:
        mean = jax.lax.pmean(mean, axis_name)
    var = jnp.mean(jnp.square(xf - mean), axis=(0, 1, 2))
    if axis_name is not None:
        var = jax.lax.pmean(var, axis_name)
    inv = jax.lax.rsqrt(var + eps) * gamma.astype(jnp.float32)
    return (xf * inv + (beta.astype(jnp.float32) - mean * inv)).astype(x.dtype)


def _flat_params(trainer, state: dict) -> dict:
    """A {network: state_dict} flattened in the port trainer's parameter order."""
    return {k: torch.cat([state[k][name].flatten() for name, _ in net.named_parameters()]).numpy()
            for k, net in trainer.nets.items()}


def _jax_pix2pix_dp_step(t, batch, cross, params, x, y):
    """gan_tpu's shard_map step over the 2 devices of ``t``'s mesh as
    tests/test_dist.py builds it, and its gradients ``pmean``-ed: (losses,
    gradients, parameters after the step). The step reads the batch from
    its inputs and cross-replica batch norm from ``bn_axis``, not from
    ``t``'s config."""
    bn = DATA_AXIS if cross == "true" else None
    opt = {"gen": t.tx_gen.init(params["gen"]), "disc": t.tx_disc.init(params["disc"])}
    rep = replicated_sharding(t.mesh)

    def step(p, o, bx, by, k):
        grads = jax.grad(t._losses, has_aux=True)(p, bx, by, k, bn)[0]
        p, o, losses = t._train_step(p, o, (bx, by), k, axis_name=DATA_AXIS, bn_axis=bn)
        return jax.lax.pmean(grads, DATA_AXIS), p, jax.lax.pmean(losses, DATA_AXIS)

    fn = jax.jit(jax.shard_map(step, mesh=t.mesh, in_specs=(P(), P(), P(DATA_AXIS),
                                                             P(DATA_AXIS), P()),
                               out_specs=(P(), P(), P()), check_vma=False))
    grads, p, losses = fn(jax.device_put(params, rep), jax.device_put(opt, rep), x[:batch],
                          y[:batch], jax.random.PRNGKey(0))
    return np.asarray(losses), jax.device_get(grads), jax.device_get(p)


def _assert_step_matches(got: dict, losses, grads: dict, params: dict, lr: float, what: str):
    """One step against another implementation's (flat per network): losses
    rtol 1e-5; each network's gradient within 1e-4 relative L2 error (fp32
    sums in other orders); the parameters after the step rtol and atol 1e-4
    (tests/test_dist.py's tolerance) wherever the gradient agreed within 2%
    of itself, and within 2·lr elsewhere: Adam's first update
    lr·g/(|g| + 1e-7) turns sum-order noise in a near-zero gradient into up
    to a sign flip (tests/test_dist.py's reason)."""
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=what)
    for k, want in grads.items():
        g = got["grads"][k]
        assert np.linalg.norm(g - want) <= 1e-4 * np.linalg.norm(want), (what, k)
        agreed = np.abs(g - want) <= 0.02 * np.abs(want)
        d = np.abs(got["params"][k] - params[k])
        assert (d[agreed] <= 1e-4 + 1e-4 * np.abs(params[k][agreed])).all(), (what, k)
        assert d.max() <= 2 * lr, (what, k)


def test_pix2pix_dp_steps_match_gan_tpu_and_the_global_batch(tmp_path, cpu_devices, monkeypatch):
    """Two ranks of the port on transplanted weights with non-zero betas:

    * cross-replica batch norm at a global batch of 4 (2 rows per rank)
      against gan_tpu's 2-device shard_map step with ``bn_axis``, and
      against the port's single-process step at the global batch;
    * per-replica batch norm at a global batch of 2 (one row per rank: K1's
      plain version with batch norm's epsilon) against gan_tpu's
      per-replica DP step (no ``bn_axis``);
    * each at ``_assert_step_matches``' tolerances;
    * both ranks hold equal parameters after every step, bit for bit;
    * a DP epoch (11 rows at a global batch of 4: 2 full steps of 2 rows
      per rank, then a 3-row remainder on both ranks, and a 5-row val
      epoch) resident as each rank's stripe and streamed from the host:
      losses, parameters and Adam's moments bit for bit."""
    monkeypatch.setattr(jax_blocks, "batch_norm", _two_pass_batch_norm)
    jcfg = jax_config.Pix2PixConfig(data="", output="", img_size=32, batch_size=4, train=True,
                                    epochs=1, dtype="fp32", num_devices=2)
    jcfg.validate()
    jax_trainer = JaxPix2Pix(jcfg, mesh=make_mesh(2, devices=cpu_devices))
    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key in ("beta", "bias") else np.asarray(a), jax.device_get(jax_trainer.params))
    state = networks_to_state_dicts(params)
    x, y = (rng.uniform(-1, 1, (4, 32, 32, 1)).astype(np.float32) for _ in range(2))
    pad = rng.integers(0, 256, (11, 2, 62, 62, 1), dtype=np.uint8)
    val = rng.integers(0, 256, (5, 2, 32, 32, 1), dtype=np.uint8)
    np.savez(tmp_path / "pix2pix.npz", x=x, y=y, train=pad, val=val)
    torch.save(state, tmp_path / "pix2pix_state.pt")
    ranks = worker.start("pix2pix_steps", tmp_path, 2, str(tmp_path))

    want = {case: _jax_pix2pix_dp_step(jax_trainer, batch, cross, params, x, y)
            for case, batch, cross in (("cross", 4, "true"), ("per_replica", 2, "false"))}
    single = Pix2PixTrainer(parse_pix2pix(["--data", "d", "--output", "o", "--train",
                                           "--epochs", "1", "--img-size", "32", "--batch-size",
                                           "4", "--dtype", "fp32"]))
    single.load_state({"params": state})
    grads, losses = single.gradients(torch.from_numpy(x), torch.from_numpy(y))
    single.apply_gradients(grads)
    flat = lambda tree: {k: torch.cat([t.detach().flatten() for t in v]).numpy()
                         for k, v in tree.items()}
    got = worker.finish(ranks, tmp_path, 2)
    os.remove(tmp_path / "pix2pix_state.pt")

    lr = single.config.learning_rate
    for case in ("cross", "per_replica"):
        assert [g[case]["local_batch"] for g in got] == [2 if case == "cross" else 1] * 2
        assert [g[case]["bn_group"] for g in got] == [case == "cross"] * 2
        assert got[0][case]["digest"] == got[1][case]["digest"]
        jax_losses, jax_grads, jax_params = want[case]
        _assert_step_matches(got[0][case], jax_losses,
                             _flat_params(single, networks_to_state_dicts(jax_grads)),
                             _flat_params(single, networks_to_state_dicts(jax_params)), lr,
                             f"{case} against gan_tpu")
    _assert_step_matches(got[0]["cross"], losses.numpy(), flat(grads), flat(single.params), lr,
                         "cross against the global batch")

    for g in got:
        resident, streamed = g["epochs"]["on"], g["epochs"]["off"]
        assert (resident["kind"], streamed["kind"]) == ("Stripe", "ndarray")
        assert [a.shape for a in resident["losses"]] == [(3, 4), (2, 4)]
        for a, b in zip(resident["losses"], streamed["losses"]):
            assert np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)
        assert resident["digest"] == streamed["digest"] == got[0]["epochs"]["on"]["digest"]
        assert resident["counts"] == {"eager": 3, "captures": 0, "replays": 0}


def test_cyclegan_dp_epoch_matches_gan_tpu(tmp_path, cpu_devices, monkeypatch):
    """19 X and 21 Y rows at a global batch of 4 over 2 devices (as
    tests/test_dist.py:239 at 8): 4 full steps from per-stripe shuffles,
    then a zip tail of 3 X and 4 Y rows drawn from the rows the full steps
    left, on every replica; the jitter's draws fixed on both sides (a crop
    at row 3, column 5, no mirror), from transplanted weights with non-zero
    norm offsets, at a learning rate of 0. With the parameters held, each
    step's losses depend on its rows alone, so every step's are held to the
    single step's tolerance of tests/test_torch_train.py, rtol 1e-4 (at
    the default rate the two packages' trajectories part: each Adam moves
    near-zero gradients by up to 2·lr, and the losses drift apart by 4e-4
    after one step and 4e-2 after four). The gradients of all five steps,
    averaged over the replicas, are held in Adam's first moments, against
    gan_tpu's: relative L2 error 1e-2 per network, the gradient tolerance
    of tests/test_torch_train.py at 32². Both ranks' parameters and Adam's
    moments equal bit for bit, and the streamed epoch equals the resident
    one. A full step's form follows the per-replica batch: with
    ``BATCHED_PASS_MAX`` 2, the global batch of 4 takes the batched form's
    3 generator passes on each replica."""
    fixed = lambda key, b, limit: (jnp.full((b,), 3, jnp.int32), jnp.full((b,), 5, jnp.int32),
                                   jnp.zeros((b,), bool))
    monkeypatch.setattr(jax_augment, "_draw_params", fixed)
    cfg = jax_config.CycleGANConfig(input_images="x", target_images="y", output="o",
                                    img_size=32, batch_size=4, train=True, epochs=1,
                                    dtype="fp32", num_devices=2, learning_rate=0.0)
    cfg.validate()
    t = JaxCycleGAN(cfg, mesh=make_mesh(2, devices=cpu_devices))
    rng = np.random.default_rng(12)
    t.params = jax.device_put(jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "offset" else np.asarray(a), jax.device_get(t.params)),
        replicated_sharding(t.mesh))
    torch.save(networks_to_state_dicts(jax.device_get(t.params)), tmp_path / "cyclegan_state.pt")
    data = np.random.default_rng(6)
    x = data.integers(0, 255, (19, 62, 62, 1), np.uint8)
    y = data.integers(0, 255, (21, 62, 62, 1), np.uint8)
    np.savez(tmp_path / "cyclegan.npz", x=x, y=y)
    ranks = worker.start("cyclegan_epoch", tmp_path, 2, str(tmp_path))

    caches = {"x": jax_loop.put_cache(x, t.mesh), "y": jax_loop.put_cache(y, t.mesh)}
    want = t._run_epoch(caches, x, y, jax.random.PRNGKey(2), training=True,
                        rng=loop.epoch_rng(cfg.seed, 0, 0))
    port = CycleGANTrainer(parse_cyclegan(["--input-images", "x", "--target-images", "y",
                                           "--output", "o", "--train", "--epochs", "1",
                                           "--img-size", "32", "--batch-size", "4"]))
    mu = _flat_params(port, networks_to_state_dicts(
        {k: jax.device_get(v[0].mu) for k, v in t.opt_states.items()}))
    got = worker.finish(ranks, tmp_path, 2)
    os.remove(tmp_path / "cyclegan_state.pt")

    assert want.shape == (5, 7)
    for g in got:
        resident, streamed = g["on"], g["off"]
        assert (resident["kind"], streamed["kind"]) == ("Stripe", "ndarray")
        np.testing.assert_array_equal(resident["losses"], streamed["losses"])
        np.testing.assert_allclose(resident["losses"], want, rtol=1e-4)
        assert resident["digest"] == streamed["digest"] == got[0]["on"]["digest"]
        assert g["passes"] == 3
    for k, m in mu.items():
        err = np.linalg.norm(got[0]["exp_avg"][k] - m) / np.linalg.norm(m)
        assert err <= 1e-2, (k, err)
    port.BATCHED_PASS_MAX = 2
    assert len(port._step_draws(0, 0, 0).masks) == 6   # the unbatched form at 4 rows


def _pairs(directory, n=12, seed=31, shape=(40, 72)):
    """``n`` seeded noise PNGs: side-by-side pairs, or single images."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, shape, np.uint8), "L").save(
            os.path.join(directory, f"p{i}.png"))
    return str(directory)


def _metrics(run):
    out = {}
    for name in ("train_metrics.json", "val_metrics.json"):
        with open(os.path.join(run, "logs", name)) as f:
            out[name] = json.load(f)
    return out


def test_cli_num_devices_2_writes_one_run_tree(tmp_path):
    """``--train --num-devices 2`` through the CLI's ``launch(run, cfg)``
    (what ``main`` calls), with the group's timeout cut to the workers' 120
    s: it spawns two ranks over gloo, and rank 0 alone writes gan_tpu's
    output tree, once, into a single run directory (the FileStore it made
    is gone)."""
    data = _pairs(tmp_path / "data")
    out = tmp_path / "out"
    argv = ["--data", data, "--output", str(out), "--train", "--epochs", "1", "--img-size",
            "32", "--batch-size", "4", "--test-img", "2", "--dtype", "fp32", "--logging",
            "false", "--num-devices", "2", "--validation-size", "0.3"]
    parallel.launch(pix2pix.run, parse_pix2pix(argv), timeout=worker.GROUP_TIMEOUT)
    assert os.listdir(out) == [os.listdir(out)[0]]   # one run directory, no store left
    run = glob.glob(str(out / "*"))[0]
    with open(os.path.join(run, "logs", "config.json")) as f:
        assert f.read() == jax_config.parse_pix2pix(argv).to_json()
    assert sorted(os.listdir(os.path.join(run, "logs"))) == [
        "config.json", "train_metrics.json", "val_metrics.json"]
    assert all(len(v) == 1 and np.isfinite(v).all()
               for m in _metrics(run).values() for v in m.values())
    assert len(os.listdir(os.path.join(run, "figs"))) == 4
    assert sorted(os.listdir(os.path.join(run, "final_test_imgs"))) == ["img0.png", "img1.png"]
    assert os.listdir(os.path.join(run, "training_checkpoints")) == ["1"]
    shutil.rmtree(os.path.join(run, "training_checkpoints"))   # whole networks and Adams


def test_cli_bn_cross_replica_changes_the_result_and_resume_repeats_the_run(tmp_path):
    """The Pix2Pix CLI's ``run`` on two ranks: ``--bn-cross-replica true``
    gives other losses than per-replica statistics (the flag is not inert),
    and 1 epoch, then ``--resume`` to 2, equals a clean 2-epoch run: the
    resumed epoch's metrics, the checkpoint's tensors and the final PNG
    bytes. The CycleGAN CLI's ``run`` on two ranks writes gan_tpu's tree."""
    data = _pairs(tmp_path / "data")
    x, y = (_pairs(tmp_path / d, n=10, seed=32 + i, shape=(40, 40))
            for i, d in enumerate(("x", "y")))
    ranks = worker.start("cli_runs", tmp_path, 2, data, x, y)
    got = worker.finish(ranks, tmp_path, 2)[0]
    runs = {k: os.path.join(str(tmp_path), v) for k, v in got["runs"].items()}
    cyclegan = runs.pop("cyclegan")
    with open(os.path.join(cyclegan, "logs", "config.json")) as f:
        assert f.read() == jax_config.parse_cyclegan(got["cyclegan_argv"]).to_json()
    assert all(len(v) == 1 and np.isfinite(v).all()
               for m in _metrics(cyclegan).values() for v in m.values())
    assert len(os.listdir(os.path.join(cyclegan, "figs"))) == 7
    assert os.listdir(os.path.join(cyclegan, "final_test_imgs")) == ["img0.png"]
    assert os.listdir(os.path.join(cyclegan, "training_checkpoints")) == ["1"]
    shutil.rmtree(os.path.join(cyclegan, "training_checkpoints"))
    clean, cross, resumed = (_metrics(runs[k]) for k in ("clean", "cross", "resumed"))
    assert all(len(v) == 2 for v in clean["train_metrics.json"].values())
    assert all(v[0] != w[0] for v, w in zip(cross["train_metrics.json"].values(),
                                            clean["train_metrics.json"].values()))
    for name in clean:
        assert resumed[name] == {k: v[1:] for k, v in clean[name].items()}
    got, want = (CheckpointManager(os.path.join(runs[k], "training_checkpoints")).restore()
                 for k in ("resumed", "clean"))
    for part in ("params", "opt_states"):
        for net in want[part]:
            flat = lambda tree: [t for t in jax.tree_util.tree_leaves(tree)
                                 if isinstance(t, torch.Tensor)]
            for a, b in zip(flat(got[part][net]), flat(want[part][net])):
                assert torch.equal(a, b), (part, net)
    for name in ("img0.png",):
        with open(os.path.join(runs["resumed"], "final_test_imgs", name), "rb") as f, \
                open(os.path.join(runs["clean"], "final_test_imgs", name), "rb") as g:
            assert f.read() == g.read()
    for run in runs.values():   # the checkpoints hold whole networks and Adams
        shutil.rmtree(os.path.join(run, "training_checkpoints"), ignore_errors=True)


def test_cli_num_devices_3_at_batch_4_exits_before_any_output(tmp_path):
    argv = ["--data", str(tmp_path), "--output", str(tmp_path / "out"), "--train", "--epochs",
            "1", "--img-size", "32", "--batch-size", "4", "--num-devices", "3"]
    with pytest.raises(SystemExit, match="global batch of 4 does not divide over 3 replicas; "
                                         "the largest number of replicas that divides it is 2"):
        pix2pix_main(parse_pix2pix(argv))
    assert not (tmp_path / "out").exists()
