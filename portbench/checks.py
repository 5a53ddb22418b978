"""Whether the timed path trains correctly: the program's first three steps,
taken through the window's own call (``run_epoch`` of epoch 0, its first
step eager, the others graph replays on the card), against the plain
reference (``portbench.reference``) from the same seed.

Four numbers are compared, each against a limit in the cell's workload file:
  ``loss``: each step's losses, |program - reference| / |reference|, the worst;
  ``grad1``: each parameter's first gradient as Adam received it, worked out
    from Adam's first moment after step 1 (m = (1 - beta_1) g), as a gap of
    norms, |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median parameter's ‖g_ref‖),
    at the median parameter: the worst reads the output bias's gradient, one
    scalar summed over every pixel, whose terms cancel and whose bf16
    rounding swings it from seed to seed;
  ``grad1_diff``: the same first gradients' difference, ‖g - g_ref‖ /
    max(‖g_ref‖, the median parameter's ‖g_ref‖), at the parameter at the
    90th percentile of these gaps: a gap of norms and a loss, means over a
    million elements, see rounding only at second order or averaged out, so a
    compute dtype below the configuration's passes them; this number sees it
    at first order, and its quantile reads the same from seed to seed;
  ``change``: each parameter's change over the three steps, read before
    step 4 runs, as a gap of norms, the worst, over the parameters whose
    reference gradient is at least a thousandth of the median one's (the
    others move under Adam by round-off alone).

The program's state is read by a hook on the trainer's per-step draw method,
which the epoch runner calls before each step; it copies Adam's moments
before step 2 and the parameters before step 4 to the host, and is removed
before the window. The reference runs after the window, once the program's
state is freed, and takes nothing the program made.
"""

from __future__ import annotations

import math

import numpy as np

CHECKED_STEPS = 3
MIN_GRAD_SHARE = 1e-3   # of the median leaf's reference gradient: below it no change is compared
DIFF_QUANTILE = 0.9     # grad1_diff's parameter: the one at this quantile of the gaps


class Snapshots:
    """Copies of the program's state during epoch 0's train pass: Adam's
    first moments after step 1 and the parameters after step 3, by leaf
    name (``network.parameter``), of the ``trained`` networks (the model's
    ``trained``: a frozen network has no Adam and no change to read)."""

    def __init__(self, trainer, trained):
        self.trainer = trainer
        self.trained = list(trained)
        self.moments: dict = {}
        self.params: dict = {}

    def _leaves(self):
        for net in self.trained:
            for name, p in self.trainer.nets[net].named_parameters():
                yield f"{net}.{name}", p, self.trainer.opts[net].state.get(p, {})

    def _hooked(self, epoch: int, stream: int, step: int):
        if epoch == 0 and stream == 0:
            if step == 1 and not self.moments:
                self.moments = {leaf: (s["exp_avg"] if "exp_avg" in s else p.new_zeros(p.shape))
                                .detach().to("cpu", copy=True) for leaf, p, s in self._leaves()}
            if step == CHECKED_STEPS and not self.params:
                self.params = {leaf: p.detach().to("cpu", copy=True)
                               for leaf, p, _ in self._leaves()}
        return self._draws(epoch, stream, step)

    def __enter__(self):
        self._draws = self.trainer._step_draws
        self.trainer._step_draws = self._hooked
        return self

    def __exit__(self, *exc):
        del self.trainer._step_draws   # the class's method again
        return False

    def readings(self, losses: np.ndarray, start: dict, beta_1: float) -> dict:
        """The program's numbers in ``portbench.reference.steps.run_steps``'
        form; ``start``: the seeded weights by leaf, on the host."""
        if not self.moments or not self.params:
            raise RuntimeError("the epoch ran fewer than 4 full steps: nothing to compare")
        return {"losses": np.asarray(losses[:CHECKED_STEPS], np.float64),
                "grad1": {k: float(m.double().norm()) / (1 - beta_1)
                          for k, m in self.moments.items()},
                "grad1_t": {k: m / (1 - beta_1) for k, m in self.moments.items()},
                "change": {k: float((p.double() - start[k].double()).norm())
                           for k, p in self.params.items()}}


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """{leaf: |got - want| / max(want, the median leaf's want)} over ``leaves``."""
    median = float(np.median(list(want.values())))
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in leaves}


def diff_gaps(got: dict, want: dict) -> dict:
    """{leaf: ‖got - want‖ / max(‖want‖, the median leaf's ‖want‖)} of the
    first gradients as tensors."""
    median = float(np.median(list(want["grad1"].values())))
    out = {}
    for k, w in want["grad1_t"].items():
        d = got["grad1_t"][k].to(w.device, w.dtype) - w
        out[k] = float(d.double().norm()) / max(want["grad1"][k], median)
    return out


def moving(want: dict) -> list:
    """The leaves whose reference gradient is at least ``MIN_GRAD_SHARE`` of the
    median leaf's: the others move under Adam by round-off alone."""
    median = float(np.median(list(want["grad1"].values())))
    return [k for k, g in want["grad1"].items() if g >= MIN_GRAD_SHARE * median]


def per_leaf(got: dict, want: dict) -> dict:
    """Each compared number's per-leaf gaps."""
    return {"grad1": leaf_gaps(got["grad1"], want["grad1"], want["grad1"]),
            "grad1_diff": diff_gaps(got, want),
            "change": leaf_gaps(got["change"], want["change"], moving(want))}


def leaf_quantile(gaps: dict, q: float) -> tuple[float, str]:
    """The ``q`` quantile of the per-leaf gaps (numpy's linear one), and the
    leaf nearest to it."""
    if not all(math.isfinite(v) for v in gaps.values()):
        return math.inf, next(k for k, v in gaps.items() if not math.isfinite(v))
    ranked = sorted(gaps, key=gaps.get)
    return float(np.quantile(list(gaps.values()), q)), ranked[round(q * (len(ranked) - 1))]


def loss_gaps(got: dict, want: dict) -> np.ndarray:
    """(steps, K) |program - reference| / |reference| of each step's losses."""
    a, b = np.asarray(got["losses"], np.float64), np.asarray(want["losses"], np.float64)
    return np.abs(a - b) / np.abs(b)


def gaps(got: dict, want: dict) -> dict:
    """{number: (reading, where)} of ``got`` against ``want``, both in
    ``run_steps``' form (module docstring)."""
    if set(got["grad1"]) != set(want["grad1"]):
        raise ValueError("the program's and the reference's parameters differ: "
                         f"{sorted(set(got['grad1']) ^ set(want['grad1']))}")
    rel = loss_gaps(got, want)
    if np.isfinite(rel).all():
        step, k = np.unravel_index(int(np.argmax(rel)), rel.shape)
        loss = (float(rel.max()), f"step {step + 1}, loss {k}")
    else:
        loss = (math.inf, "not finite")
    leaves = per_leaf(got, want)
    return {"loss": loss, "grad1": leaf_quantile(leaves["grad1"], 0.5),
            "grad1_diff": leaf_quantile(leaves["grad1_diff"], DIFF_QUANTILE),
            "change": leaf_quantile(leaves["change"], 1.0)}


def details(got: dict, want: dict, top: int = 5) -> dict:
    """For the calibration's look at what each number measures: the worst
    loss gap of each step, each number's sorted per-leaf gaps, and the
    leaves that read worst."""
    out = {"loss_by_step": loss_gaps(got, want).max(axis=1).tolist()}
    for name, g in per_leaf(got, want).items():
        out[name + "_sorted"] = sorted(g.values())
        out[name + "_top"] = [[k, g[k]] for k in sorted(g, key=g.get, reverse=True)[:top]]
    return out


def reference_readings(cell: dict, seed: int, device, q=None) -> dict:
    """The reference's numbers for the cell at ``seed`` on ``device``: its own
    networks with the seeded weights, the seeded rows (or the cell's files,
    decoded by the reference), in float32 with TF32 off (``q``: the
    control's rounding of conv operands)."""
    import torch
    from portbench import cells
    from portbench.reference import nets, steps

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c = cell["config"]
        model = cells.model(c)
        built = model.build(c)
        weights = cells.make_weights(c, seed, device)
        for net, module in built.items():
            module.to(device)
            module.load_state_dict(weights[net])
        del weights
        rows = model.reference_rows(cell, seed, device)
        return steps.run_steps(c, built, rows, seed, CHECKED_STEPS, q=q or nets.identity)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def start_weights(cell: dict, seed: int, device) -> dict:
    """The seeded weights by leaf, on the host."""
    from portbench import cells
    w = cells.make_weights(cell["config"], seed, device)
    return {f"{net}.{n}": t.cpu() for net, ps in w.items() for n, t in ps.items()}


def verdict(readings: dict, limits: dict) -> bool:
    return all(readings[k][0] <= limits[k] for k in limits)
