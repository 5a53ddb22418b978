"""Faults planted in the program's trainer, for the checks' own tests and
for reading what a broken step gives (``calibrate.py --fault``): each
patches one trainer in place, under the timed path."""

from __future__ import annotations


def unchanged(trainer) -> None:
    """A step that leaves the state as it was: no update is applied."""
    trainer.apply_gradients = lambda grads: None


def half_batch(trainer) -> None:
    """Each train step takes the first half of its batch and the mean over
    those rows alone; each generator application keeps the dropout masks of
    the rows it kept, also where the half batch runs the other form of the
    passes (``trainer.passes``: a full step's every input carries the batch)."""
    import torch
    step = trainer.train_step

    def half(x, y, generators=None, masks=None, bn_group=None):
        b, h = x.shape[0], max(1, x.shape[0] // 2)
        if masks is not None and hasattr(trainer, "passes"):
            made = {}   # each application's keep-masks, by the image it makes
            for drawn, (_net, _inputs, outputs) in zip(masks, trainer.passes(b, y.shape[0])):
                for j, name in enumerate(outputs):
                    made[name] = [m[j * b:j * b + h] for m in drawn]
            masks = [[torch.cat([made[name][site] for name in outputs])
                      for site in range(len(made[outputs[0]]))]
                     for _net, _inputs, outputs in trainer.passes(h, min(h, y.shape[0]))]
        elif masks is not None:
            masks = [[m[:h] for m in drawn] for drawn in masks]
        return step(x[:h], y[:h], generators, masks, bn_group)

    trainer.train_step = half


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
