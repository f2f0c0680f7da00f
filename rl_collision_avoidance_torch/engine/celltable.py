"""Static spatial index: per-cell candidate segment lists.

Counterpart of ``rl_collision_avoidance_tpu/engine/celltable.py``.  The
table is built host-side in numpy, once per world: a coarse grid where each
cell stores every segment within ``max_range`` (+ cell slack) of any point
in the cell, so a runtime lookup is one small gather and the result is an
exact superset of the reachable segments.  Padding entries are degenerate
(far away, e = 0) and can never hit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DEGENERATE = np.asarray([1e7, 1e7, 0.0, 0.0], np.float32)


@dataclasses.dataclass(frozen=True)
class CellTable:
    table: np.ndarray      # (C, K, 4) [px, py, ex, ey]
    counts: np.ndarray     # (C,) valid entries per cell
    lo: np.ndarray         # (2,) grid origin
    cell: float            # cell edge length
    shape: tuple[int, int]  # (nx, ny)

    @property
    def k(self) -> int:
        return int(self.table.shape[1])


def _point_segment_dist(pts, seg_p, seg_e):
    po = pts[:, None, :] - seg_p[None, :, :]
    ee = np.maximum((seg_e * seg_e).sum(-1), 1e-12)
    t = np.clip((po * seg_e[None]).sum(-1) / ee, 0.0, 1.0)
    closest = seg_p[None] + t[:, :, None] * seg_e[None]
    return np.linalg.norm(pts[:, None, :] - closest, axis=-1)


def build_cell_table(seg_p, seg_e, seg_valid, max_range: float,
                     cell: float = 1.0, pad_multiple: int = 8) -> CellTable:
    """Host-side, once per world.  ``pad_multiple``: K is rounded up to it
    (8 for the lidar table, as the kernel path of the JAX package builds it;
    2 for the wall table)."""
    seg_p = np.asarray(seg_p, np.float32)[np.asarray(seg_valid)]
    seg_e = np.asarray(seg_e, np.float32)[np.asarray(seg_valid)]
    lo = np.minimum(seg_p, seg_p + seg_e).min(axis=0)
    hi = np.maximum(seg_p, seg_p + seg_e).max(axis=0)
    nx = max(1, int(np.ceil((hi[0] - lo[0]) / cell)))
    ny = max(1, int(np.ceil((hi[1] - lo[1]) / cell)))
    centers = np.stack(np.meshgrid(
        lo[0] + (np.arange(nx) + 0.5) * cell,
        lo[1] + (np.arange(ny) + 0.5) * cell, indexing="ij"),
        axis=-1).reshape(-1, 2)                       # (C, 2), x-major
    slack = cell * np.sqrt(2.0) / 2.0 + 1e-3
    lists = []
    kmax = 1
    chunk = max(1, 4_000_000 // max(len(seg_p), 1))
    for start in range(0, len(centers), chunk):
        d = _point_segment_dist(centers[start:start + chunk], seg_p, seg_e)
        for row in d:
            idx = np.nonzero(row <= max_range + slack)[0]
            lists.append(idx)
            kmax = max(kmax, len(idx))
    k = ((kmax + pad_multiple - 1) // pad_multiple) * pad_multiple
    packed = np.concatenate([seg_p, seg_e], axis=-1)  # (S, 4)
    table = np.tile(_DEGENERATE, (len(centers), k, 1)).astype(np.float32)
    counts = np.zeros(len(centers), np.int32)
    for c, idx in enumerate(lists):
        table[c, :len(idx)] = packed[idx]
        counts[c] = len(idx)
    return CellTable(table=table, counts=counts, lo=lo.astype(np.float32),
                     cell=float(cell), shape=(nx, ny))


def lookup_cells(lo, cell: float, shape, pos: torch.Tensor) -> torch.Tensor:
    """pos (..., 2) -> flat cell indices (...,) int64 of a table with origin
    ``lo`` (two floats), edge ``cell`` and grid ``shape`` (nx, ny)."""
    nx, ny = shape
    ix = ((pos[..., 0] - float(lo[0])) / cell).to(torch.int32).clamp(0, nx - 1)
    iy = ((pos[..., 1] - float(lo[1])) / cell).to(torch.int32).clamp(0, ny - 1)
    return (ix * ny + iy).long()
