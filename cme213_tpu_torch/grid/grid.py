"""Halo grid: geometry, the initial state and the text dump.

Counterpart of ``cme213_tpu/grid/grid.py``.  The grid is a ``(gy, gx)``
tensor, x contiguous; element (x, y) is ``grid[y, x]`` and y=0 is the
*bottom* row.  Dirichlet BCs fill the border band of width ``border_size``:
bottom and top bands first, then left/right bands over the corners (the
reference's BC loop order, ``hw/hw2/programming/2dHeat.cu:326-344``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import SimParams
from ..core.platform import resolve_device


@dataclass(frozen=True)
class HaloGrid:
    """Static grid geometry (the non-array part of the reference's Grid)."""

    nx: int
    ny: int
    border_size: int

    @property
    def gx(self) -> int:
        return self.nx + 2 * self.border_size

    @property
    def gy(self) -> int:
        return self.ny + 2 * self.border_size

    @classmethod
    def from_params(cls, params: SimParams) -> "HaloGrid":
        # same validity checks as the reference Grid ctor (2dHeat.cu:312-313)
        if not (params.nx > 2 * params.border_size
                and params.ny > 2 * params.border_size):
            raise ValueError(f"grid {params.nx}x{params.ny} is too small for "
                             f"border {params.border_size}")
        return cls(nx=params.nx, ny=params.ny, border_size=params.border_size)


def make_initial_grid(params: SimParams, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """(gy, gx) tensor: interior = ic, border bands = Dirichlet BC values.

    Every value is one scalar rounded once to ``dtype``, the bits of the
    JAX package's float64 grid cast to it; the grid is built on
    ``device`` itself, so a grid for a card never crosses the link.
    ``device`` defaults to ``cuda`` (``core.platform.resolve_device``).
    """
    b = params.border_size
    g = torch.full((params.gy, params.gx), params.ic, dtype=dtype,
                   device=resolve_device(device))
    g[:b, :] = params.bc_bottom
    g[b + params.ny:, :] = params.bc_top
    g[:, :b] = params.bc_left
    g[:, b + params.nx:] = params.bc_right
    return g


def interior(grid: torch.Tensor, border_size: int) -> torch.Tensor:
    """The (ny, nx) interior view of a halo grid."""
    b = border_size
    return grid[b:-b, b:-b] if b else grid


def save_grid_to_file(grid, path: str) -> None:
    """Text dump, top row first — the format of ``Grid::saveStateToFile``
    (``hw/hw2/programming/2dHeat.cu:283-293,350-359``): 3 significant digits,
    width-5 fields, y descending."""
    g = grid.detach().cpu().numpy() if torch.is_tensor(grid) \
        else np.asarray(grid)
    with open(path, "w") as f:
        for y in range(g.shape[0] - 1, -1, -1):
            f.write(" ".join(f"{v:5.3g}" for v in g[y]) + " \n")
        f.write("\n")
