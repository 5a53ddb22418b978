"""pix2pixHD's inputs, built on the device inside the step (NVIDIA/pix2pixHD
models/pix2pixHD_model.py ``encode_input`` and ``get_edges``).

A row is uint8 (H, W, 6): the label id, the instance id's high and low
byte, and the image's R, G, B (``pipeline.pix2pixhd_sample``). A step
mirrors each row whose flip draw is on (pix2pixHD flips label, instance and
image together with p 0.5), then makes the generator's input: the label's
one-hot over ``label_nc`` classes and, unless ``--no_instance``, the
instance map's edges (a pixel is an edge where its id differs from a
4-neighbour's) as one more channel; and the image scaled to [-1, 1].
"""

from __future__ import annotations

import torch

LABEL, INST_HI, INST_LO = 0, 1, 2
RGB = slice(3, 6)
ROW_CHANNELS = 6


def flip_rows(u8: torch.Tensor, flip: torch.Tensor | None) -> torch.Tensor:
    """Rows (B, H, W, C) with row b mirrored left-right where ``flip[b]``."""
    if flip is None:
        return u8
    return torch.where(flip[:, None, None, None], u8.flip(2), u8)


def edges(ids: torch.Tensor) -> torch.Tensor:
    """``get_edges`` of (B, H, W) ids: True where a pixel's id differs from
    its left, right, upper or lower neighbour's."""
    e = torch.zeros_like(ids, dtype=torch.bool)
    dx = ids[:, :, 1:] != ids[:, :, :-1]
    dy = ids[:, 1:, :] != ids[:, :-1, :]
    e[:, :, 1:] |= dx
    e[:, :, :-1] |= dx
    e[:, 1:, :] |= dy
    e[:, :-1, :] |= dy
    return e


def hd_inputs(u8: torch.Tensor, flip: torch.Tensor | None, *, label_nc: int,
              instance: bool = True, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(input (B, H, W, label_nc [+ 1]), image (B, H, W, 3)) in ``dtype`` of
    uint8 rows (B, H, W, 6) on the device, mirrored by ``flip`` ((B,) bool,
    or None)."""
    u8 = flip_rows(u8, flip)
    classes = torch.arange(label_nc, device=u8.device, dtype=torch.uint8)
    parts = [(u8[..., LABEL:LABEL + 1] == classes).to(dtype)]
    if instance:
        ids = u8[..., INST_HI].to(torch.int32) * 256 + u8[..., INST_LO].to(torch.int32)
        parts.append(edges(ids)[..., None].to(dtype))
    image = u8[..., RGB].to(dtype) / 127.5 - 1.0
    return torch.cat(parts, dim=-1), image
