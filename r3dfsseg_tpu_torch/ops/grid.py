"""Spatial grid pooling for MDNS (counterpart of `r3dfsseg_tpu/ops/grid.py`)."""
from __future__ import annotations

import torch


def grid_seed_pool(xyz: torch.Tensor, feat: torch.Tensor, valid: torch.Tensor,
                   n_cells: tuple[int, int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean features per cell of a fixed grid over the valid points.

    Batched over any leading axes: xyz (..., N, 3), feat (..., N, C),
    valid (..., N) bool -> seeds (..., cells, C) (0 where empty) and
    seed_valid (..., cells).  The box spans the valid points only; cell c
    along an axis covers [lo + c*d, lo + (c+1)*d] with closed bounds on both
    ends; cells are ordered x -> y -> z.
    """
    n_x, n_y, n_z = n_cells
    xyz = xyz.float()
    big = 3.4e38
    v3 = valid[..., None]
    lo = torch.where(v3, xyz, big).amin(-2)                      # (..., 3)
    hi = torch.where(v3, xyz, -big).amax(-2)
    counts = torch.tensor([n_x, n_y, n_z], dtype=torch.float32, device=xyz.device)
    d = (hi - lo) / counts

    def axis_masks(axis: int, n: int) -> torch.Tensor:
        """(..., n, N) closed-interval membership along one axis."""
        steps = torch.arange(n, dtype=torch.float32, device=xyz.device)
        starts = lo[..., axis, None] + d[..., axis, None] * steps   # (..., n)
        ends = starts + d[..., axis, None]
        p = xyz[..., None, :, axis]                                 # (..., 1, N)
        return (p >= starts[..., None]) & (p <= ends[..., None])

    mx = axis_masks(0, n_x)
    my = axis_masks(1, n_y)
    mz = axis_masks(2, n_z)
    cell = (mx[..., :, None, None, :] & my[..., None, :, None, :]
            & mz[..., None, None, :, :])
    cell = cell.flatten(-4, -2) & valid[..., None, :]             # (..., cells, N)
    w = cell.float()
    sums = torch.matmul(w, feat.float())
    cnt = w.sum(-1)
    seed_valid = cnt > 0.0
    seeds = sums / cnt.clamp_min(1.0)[..., None]
    seeds = torch.where(seed_valid[..., None], seeds, 0.0)
    return seeds.to(feat.dtype), seed_valid
