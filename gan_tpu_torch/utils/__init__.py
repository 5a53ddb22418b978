"""Output contract: timestamped run dirs, Log.txt redirect, JSON dumps,
prediction image grids and loss figures (matplotlib is imported only when a
grid or figure is drawn)."""

from gan_tpu_torch.utils.figs import write_loss_figs
from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.outputs import (RunDirs, dump_json, make_run_dirs, redirect_logging,
                                         silence)

__all__ = ["RunDirs", "make_run_dirs", "redirect_logging", "silence", "dump_json",
           "save_image_grid", "write_loss_figs"]
