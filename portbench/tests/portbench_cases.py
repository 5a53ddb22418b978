"""Small cells for the CPU tests."""


def tiny(name: str, **config) -> dict:
    """The cell ``name`` at 32x32 with a corpus of a few batches: 4 full
    steps and a 2-row tail (CycleGAN: a zip tail of 1 X and 3 Y rows)."""
    from portbench import cells
    cell = cells.load(name)
    c = cell["config"]
    c.update(img_size=32, **config)
    if c["model"] == "pix2pix":
        c.update(train_pairs=18, val_pairs=6)
    else:
        c.update(train_x=17, train_y=19, val_x=6, val_y=7)
    if cell["storage"] == "files":
        cell["corpus"] = dict(cell["corpus"], width=80, height=32)
    return cell
