#!/usr/bin/env python3
"""Convert a gan_tpu training checkpoint (orbax) into a checkpoint of the
PyTorch port (gan_tpu_torch), Adam state included.

    python tools/convert_gan_tpu_checkpoint.py RUN --output OUT [--epoch N]
    python -m gan_tpu_torch.pix2pix ... --predict --weights OUT
    python -m gan_tpu_torch.pix2pix ... --train --resume OUT --epochs M

RUN is a gan_tpu run directory (``logs/config.json`` and
``training_checkpoints/``) or its ``training_checkpoints/``. Its config gives
the model, image size, channels and the rest; the gan_tpu trainer of that
config is the restore target of the latest epoch (or ``--epoch N``). The
port's trainer of the same config, on the CPU, takes the converted
parameters and Adam moments and writes its own ``state()`` into
``OUT/training_checkpoints/<epoch>/state.pt`` (``--resume OUT`` starts after
that epoch); the config is copied to ``OUT/logs/config.json``.

A TF-reference checkpoint takes two steps: ``tools/import_tf_checkpoint.py``
writes a bare orbax checkpoint directory without a config and without Adam
slots, then this tool, told ``--model``, ``--img-size`` and ``--channels``,
converts it; the port's Adams then start at step 0.

Needs jax and orbax (for the source) and torch; runs everything on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _source(path: str) -> tuple[str, str | None]:
    """(orbax checkpoint root, the run's config.json or None)."""
    path = os.path.abspath(path)
    cand = os.path.join(path, "training_checkpoints")
    ckpt, run = (cand, path) if os.path.isdir(cand) else (path, os.path.dirname(path))
    if not os.path.isdir(ckpt):
        raise SystemExit(f"no checkpoint directory at {path}")
    config = os.path.join(run, "logs", "config.json")
    return ckpt, config if os.path.isfile(config) else None


def _config(cls, fields: dict):
    """A config dataclass from config.json's fields (``lambda`` is ``lam``)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (("lam" if k == "lambda" else k, v)
                                    for k, v in fields.items()) if k in names})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("convert_gan_tpu_checkpoint")
    ap.add_argument("run", help="gan_tpu run dir, or its training_checkpoints/")
    ap.add_argument("--output", required=True, help="directory for the port's checkpoint")
    ap.add_argument("--epoch", type=int, default=None, help="epoch to convert (default: latest)")
    ap.add_argument("--model", choices=["pix2pix", "cyclegan"], default=None,
                    help="needed without a config.json (an imported TF checkpoint)")
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--channels", choices=["1", "3"], default=None)
    args = ap.parse_args(argv)

    os.environ["GAN_TPU_PLATFORM"] = "cpu"   # both packages on the CPU
    import jax

    from gan_tpu import config as jax_config
    from gan_tpu.parallel.mesh import make_mesh
    from gan_tpu.train.checkpoint import CheckpointManager as OrbaxManager
    from gan_tpu_torch import config as port_config
    from gan_tpu_torch.train.checkpoint import CheckpointManager
    from gan_tpu_torch.transplant import trainer_state

    ckpt_dir, config_path = _source(args.run)
    fields = {}
    if config_path:
        with open(config_path) as f:
            fields = json.load(f)
    model = args.model or ("pix2pix" if "data" in fields else
                           "cyclegan" if "input_images" in fields else None)
    if model is None:
        raise SystemExit(f"no logs/config.json beside {ckpt_dir}: give --model, "
                         "--img-size and --channels")
    fields.update({k: v for k, v in (("img_size", args.img_size), ("channels", args.channels))
                   if v is not None})
    fields.update(num_devices=1, train=True, predict=False)
    if model == "pix2pix":
        from gan_tpu.train.pix2pix_trainer import Pix2PixTrainer as JaxTrainer
        from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer as PortTrainer
        jcfg, pcfg = (_config(m.Pix2PixConfig, fields) for m in (jax_config, port_config))
    else:
        from gan_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxTrainer
        from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer as PortTrainer
        jcfg, pcfg = (_config(m.CycleGANConfig, fields) for m in (jax_config, port_config))

    source = OrbaxManager(ckpt_dir)
    epoch = source.latest_epoch() if args.epoch is None else args.epoch
    if epoch is None:
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    state = jax.device_get(source.restore(JaxTrainer(jcfg, mesh=make_mesh(1)).state(), epoch))
    source.close()

    trainer = PortTrainer(pcfg)
    trainer.load_state(trainer_state(
        state, trainer.nets, {k: opt.state_dict()["param_groups"] for k, opt in trainer.opts.items()}))
    out = os.path.abspath(args.output)
    CheckpointManager(os.path.join(out, "training_checkpoints")).save(epoch, trainer.state())
    if config_path:
        os.makedirs(os.path.join(out, "logs"), exist_ok=True)
        shutil.copyfile(config_path, os.path.join(out, "logs", "config.json"))
    steps = {k: int(s[0].count) for k, s in state["opt_states"].items()}
    print(f"Converted {model} epoch {epoch} from {ckpt_dir} into "
          f"{os.path.join(out, 'training_checkpoints', str(epoch))} (Adam steps {steps})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
