"""The spawned ranks of tests/test_torch_dist.py and
tests/test_torch_recovery.py: jax-free, so that a child process imports
torch and the port only.

``start(name, tmp, size, *args)`` spawns ``size`` ranks that meet over gloo
through a FileStore in ``tmp`` (no TCP port, so parallel test workers
cannot collide), each with one torch thread and a group timeout; each rank
runs ``name(replicas, tmp, *args)`` from this module and saves what it
returns to ``tmp/rank<r>.pt``. ``finish`` joins them within a time limit and
loads the results. ``fault_main(argv)`` runs the Pix2Pix CLI through
``parallel.launch`` with a fault injected on rank 1."""

from __future__ import annotations

import hashlib
import os
from datetime import timedelta

import numpy as np
import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT = timedelta(seconds=120)
JOIN_TIMEOUT = 120.0   # seconds


def start(name: str, tmp, size: int, *args):
    return mp.start_processes(_entry, args=(name, str(tmp), size, args), nprocs=size,
                              join=False, start_method="spawn")


def finish(context, tmp, size: int) -> list:
    """Every rank's result (its file removed: some hold whole networks);
    raises if a rank failed or the ranks outlast ``JOIN_TIMEOUT``."""
    import time
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not context.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in context.processes:
                p.kill()
            raise TimeoutError(f"the ranks ran longer than {JOIN_TIMEOUT} s")
    out = []
    for r in range(size):
        path = os.path.join(str(tmp), f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    return out


def _entry(rank: int, name: str, tmp: str, size: int, args) -> None:
    os.environ["GAN_TPU_PLATFORM"] = "cpu"
    torch.set_num_threads(1)
    import torch.distributed as dist
    from gan_tpu_torch import parallel

    store = dist.FileStore(os.path.join(tmp, "store"), size)
    replicas = parallel.join(rank, size, torch.device("cpu"), store=store, timeout=GROUP_TIMEOUT)
    try:
        out = globals()[name](replicas, tmp, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        parallel.leave(replicas)


def _flat(tensors: dict) -> dict:
    """{network: its tensors}, each network's flattened into one numpy array."""
    return {k: torch.cat([t.detach().flatten() for t in v]).numpy().copy()
            for k, v in tensors.items()}


def _digest(trainer) -> dict:
    """A SHA-256 of each network's parameters and of its Adam moments: equal
    digests are equal tensors, bit for bit."""
    adam = {k: [s[m] for s in opt.state.values() for m in ("exp_avg", "exp_avg_sq")]
            for k, opt in trainer.opts.items()}
    return {part: {k: hashlib.sha256(a.tobytes()).hexdigest() for k, a in _flat(tree).items()}
            for part, tree in (("params", trainer.params), ("adam", adam))}


def pix2pix_steps(replicas, tmp: str, inputs: str) -> dict:
    """One Pix2Pix step with cross-replica batch norm at a global batch of 4
    (2 rows per rank: rank r takes rows [2r, 2r + 2), the block a 2-device
    shard_map gives device r), one with per-replica batch norm at a global
    batch of 2 (a row per rank), each from the transplanted state; then a
    DP epoch of 11 rows at a global batch of 4 resident and streamed from
    the host from one state."""
    from gan_tpu_torch.config import parse_pix2pix
    from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer

    data = np.load(os.path.join(inputs, "pix2pix.npz"))
    state = torch.load(os.path.join(inputs, "pix2pix_state.pt"), weights_only=True)
    r = replicas.rank

    def trainer(batch, cross, *extra):
        cfg = parse_pix2pix(["--data", "d", "--output", "o", "--train", "--epochs", "1",
                             "--img-size", "32", "--batch-size", str(batch), "--dtype", "fp32",
                             "--bn-cross-replica", cross, "--num-devices", "2", *extra])
        t = Pix2PixTrainer(cfg, replicas)
        t.load_state({"params": state})
        return t

    out = {}
    for case, batch, cross in (("cross", 4, "true"), ("per_replica", 2, "false")):
        t = trainer(batch, cross)
        b = t.local_batch
        x, y = (torch.from_numpy(data[k][r * b:(r + 1) * b]) for k in ("x", "y"))
        grads, losses = t.gradients(x, y, bn_group=t.bn_group)
        t.apply_gradients(grads)
        out[case] = {"local_batch": b, "bn_group": t.bn_group is not None,
                     "losses": losses.numpy(), "digest": _digest(t)}
        if r == 0:   # the parent compares one rank's step in full
            out[case].update(params=_flat(t.params), grads=_flat(grads))
    epochs = {}
    for cache in ("on", "off"):
        t = trainer(4, "true", "--device-cache", cache)
        (train,), (val,) = t._plan_caches([(data["train"],), (data["val"],)])
        losses = [t.run_epoch(train, 0, training=True), t.run_epoch(val, 0, training=False)]
        epochs[cache] = {"kind": type(train).__name__, "losses": losses, "digest": _digest(t),
                         "counts": dict(t.epoch_counts)}
    out["epochs"] = epochs
    return out


def cyclegan_epoch(replicas, tmp: str, inputs: str) -> dict:
    """A CycleGAN DP train epoch over 19 X and 21 Y rows at a global batch of
    4 (4 full steps of 2 rows per rank, then a zip tail of 3 X and 4 Y rows
    on both ranks), resident and streamed from the host, from the
    transplanted state at a learning rate of 0, with the jitter's draws
    fixed (a crop at row 3, column 5, no mirror); and the forms a full step
    takes."""
    from gan_tpu_torch.config import parse_cyclegan
    from gan_tpu_torch.data import augment
    from gan_tpu_torch.train import cyclegan_trainer
    from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

    def fixed_draws(b, src, img_size, generator, device):
        return (torch.full((b,), 3, device=device), torch.full((b,), 5, device=device),
                torch.zeros(b, dtype=torch.bool, device=device))

    augment.jitter_draws = cyclegan_trainer.jitter_draws = fixed_draws
    data = np.load(os.path.join(inputs, "cyclegan.npz"))
    state = torch.load(os.path.join(inputs, "cyclegan_state.pt"), weights_only=True)
    out = {}
    for cache in ("on", "off"):
        cfg = parse_cyclegan(["--input-images", "x", "--target-images", "y", "--output", "o",
                              "--train", "--epochs", "1", "--img-size", "32", "--batch-size",
                              "4", "--dtype", "fp32", "--num-devices", "2",
                              "--device-cache", cache, "--learning-rate", "0"])
        t = CycleGANTrainer(cfg, replicas)
        t.load_state({"params": state})
        (x, y), _ = t._plan_caches([(data["x"], data["y"])] * 2)   # (train, val)
        out[cache] = {"kind": type(x).__name__, "losses": t.run_epoch(x, y, 0, training=True),
                      "digest": _digest(t)}
    if replicas.rank == 0:
        out["exp_avg"] = _flat({k: [s["exp_avg"] for s in opt.state.values()]
                                for k, opt in t.opts.items()})
    t.BATCHED_PASS_MAX = 2   # rows: the per-replica batch, not the global one
    out["passes"] = len(t._step_draws(0, 0, 0).masks)
    return out


def cli_runs(replicas, tmp: str, data: str, x: str, y: str) -> dict:
    """The Pix2Pix CLI's ``run`` on both ranks: 2 epochs with per-replica
    batch norm, 1 epoch with cross-replica batch norm, and 1 epoch, then
    ``--resume`` of it to 2; and the CycleGAN CLI's for 1 epoch (the loss
    figures stubbed to empty files: matplotlib takes seconds to import).
    Returns each run's directory, and the CycleGAN run's arguments."""
    from gan_tpu_torch import cycle_gan, pix2pix
    from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix

    def no_figs(train, val, prefix, output_path):
        os.makedirs(output_path, exist_ok=True)
        for k in train:
            open(os.path.join(output_path, f"{prefix}{k}.png"), "wb").close()

    pix2pix.write_loss_figs = cycle_gan.write_loss_figs = no_figs
    runs = {}
    for name, extra in (("clean", ["--epochs", "2"]),
                        ("cross", ["--epochs", "1", "--bn-cross-replica", "true",
                                   "--save-weights", "false"]),
                        ("first", ["--epochs", "1"]),
                        ("resumed", ["--epochs", "2", "--resume", "first"])):
        out = os.path.join(tmp, name)
        extra = [os.path.join(tmp, runs["first"]) if a == "first" else a for a in extra]
        pix2pix.run(parse_pix2pix(["--data", data, "--output", out, "--train", "--img-size",
                                   "32", "--batch-size", "4", "--test-img", "1", "--dtype",
                                   "fp32", "--logging", "false", "--num-devices", "2",
                                   "--validation-size", "0.3", *extra]), replicas)
        (stamp,) = os.listdir(out)
        runs[name] = os.path.join(name, stamp)
    out = os.path.join(tmp, "cyclegan")
    argv = ["--input-images", x, "--target-images", y, "--output", out, "--train", "--epochs",
            "1", "--img-size", "32", "--batch-size", "4", "--test-img", "1", "--dtype", "fp32",
            "--logging", "false", "--num-devices", "2", "--validation-size", "0.3"]
    cycle_gan.run(parse_cyclegan(argv), replicas)
    (stamp,) = os.listdir(out)
    runs["cyclegan"] = os.path.join("cyclegan", stamp)
    return {"runs": runs, "cyclegan_argv": argv}


def fault_on_rank_1(cfg, replicas) -> None:
    """The Pix2Pix CLI's ``run`` on one rank of ``fault_main``'s world, rank 1
    raising a fault as its 2nd train epoch starts (a spawned rank does not
    inherit the test's monkeypatches)."""
    from gan_tpu_torch import pix2pix
    from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer

    if replicas.rank == 1:
        real, calls = Pix2PixTrainer.run_epoch, []

        def run_epoch(self, *args, training):
            if training:
                calls.append(args[-1])
                if len(calls) == 2:
                    raise RuntimeError("injected fault on rank 1")
            return real(self, *args, training=training)

        Pix2PixTrainer.run_epoch = run_epoch
    pix2pix.run(cfg, replicas)


def fault_main(argv: list) -> None:
    """The Pix2Pix CLI's ``main`` on ``argv`` through ``parallel.launch``, each
    rank ``fault_on_rank_1``."""
    from gan_tpu_torch import parallel
    from gan_tpu_torch.config import parse_pix2pix

    parallel.launch(fault_on_rank_1, parse_pix2pix(argv))
