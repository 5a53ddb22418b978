"""Faults planted in the program's trainer, for the checks' own tests and
for reading what a broken step gives (``calibrate.py --fault``): each
patches one trainer in place, under the timed path."""

from __future__ import annotations


def unchanged(trainer) -> None:
    """A step that leaves the state as it was: no update is applied."""
    trainer.apply_gradients = lambda grads: None


def half_batch(trainer) -> None:
    """Each train step takes the first half of its batch and the mean over
    those rows alone; its dropout keeps the masks of the rows it kept."""
    import torch
    step = trainer.train_step

    def half(x, y, generators=None, masks=None, bn_group=None):
        b, h = x.shape[0], max(1, x.shape[0] // 2)
        if masks is not None:
            passes = (trainer.passes(b, y.shape[0]) if hasattr(trainer, "passes")
                      else ((None, ("x",), None),))
            masks = [[torch.cat([m[j * b:j * b + h] for j in range(len(inputs))]) for m in drawn]
                     for drawn, (_net, inputs, _out) in zip(masks, passes)]
        return step(x[:h], y[:h], generators, masks, bn_group)

    trainer.train_step = half


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
