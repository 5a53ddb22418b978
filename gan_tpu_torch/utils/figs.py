"""Loss figures: train/val line plots per loss key (counterpart of
gan_tpu/utils/figs.py). matplotlib is imported on first use, so the package
imports where it is absent."""

from __future__ import annotations

import os


def make_fig(train_values, val_values, title: str, output_path: str) -> None:
    """``<output_path>/<title>.png`` at dpi 200, 1-based epoch x-axis."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 8), dpi=80)
    plt.plot(range(1, len(train_values) + 1), train_values, alpha=0.7, label="Training")
    plt.plot(range(1, len(val_values) + 1), val_values, alpha=0.7, label="Validation")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend()
    plt.title(f"{title}")
    plt.tight_layout()
    os.makedirs(output_path, exist_ok=True)
    plt.savefig(os.path.join(output_path, f"{title}.png"), dpi=200)
    plt.close()


def write_loss_figs(train_metrics: dict, val_metrics: dict, *, prefix: str,
                    output_path: str) -> None:
    """One figure per loss key, titled ``prefix + key`` ('CycleGAN ...')."""
    for key in train_metrics:
        make_fig(train_metrics[key], val_metrics.get(key, []), title=prefix + key,
                 output_path=output_path)
