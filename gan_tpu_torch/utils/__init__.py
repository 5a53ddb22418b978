"""Output contract: timestamped run dirs, Log.txt redirect, JSON dumps and
prediction image grids (matplotlib is imported only when a grid is drawn)."""

from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.outputs import RunDirs, dump_json, make_run_dirs, redirect_logging

__all__ = ["RunDirs", "make_run_dirs", "redirect_logging", "dump_json", "save_image_grid"]
