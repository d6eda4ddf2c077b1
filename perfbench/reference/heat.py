"""Plain reference of the hw2/hw5 heat solve, written from the 2012
sources (``hw/hw2/programming/2dHeat.cu``: the grid, ``calcDtCFL`` and the
central-difference update) in plain PyTorch.

The grid is ``(gy, gx)`` with y = 0 the bottom row and a Dirichlet band of
``border`` cells on each side.  One step replaces the interior by

    u + xcfl * sum_k c_k u[y, x + k - b] + ycfl * sum_k c_k u[y + k - b, x]

with the taps accumulated in coefficient order and every product and sum
rounded on its own, in the grid's dtype.  Nothing here imports the
program.
"""

from __future__ import annotations

import torch

#: order -> 1-D second-derivative coefficients (the 2012 stencils)
COEFFS = {
    2: (1.0, -2.0, 1.0),
    4: (-1.0, 16.0, -30.0, 16.0, -1.0),
    8: (-9.0, 128.0, -1008.0, 8064.0, -14350.0, 8064.0, -1008.0, 128.0,
        -9.0),
}
BORDER = {2: 1, 4: 2, 8: 4}


def cfl(order: int, nx: int, ny: int, lx: float, ly: float,
        alpha: float) -> tuple[float, float]:
    """(xcfl, ycfl) of ``calcDtCFL``: a step just under the 0.5 limit,
    scaled by the order's finite-difference denominator."""
    dx, dy = lx / (nx - 1), ly / (ny - 1)
    dx2, dy2 = dx * dx, dy * dy
    margin = 0.5 - 0.0001
    if order == 2:
        denom = 1
        dt = margin * (dx2 * dy2) / (alpha * (dx2 + dy2))
    elif order == 4:
        denom = 12
        dt = margin * (12 * dx2 * dy2) / (16 * alpha * (dx2 + dy2))
    else:
        denom = 5040
        dt = margin * (5040 * dx2 * dy2) / (8064 * alpha * (dx2 + dy2))
    return alpha * dt / (denom * dx2), alpha * dt / (denom * dy2)


def initial_grid(nx: int, ny: int, order: int, ic: float,
                 bc: tuple[float, float, float, float], dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
    """Interior ``ic``; bands ``bc`` = (top, left, bottom, right), rows
    first and then columns over the corners, as the 2012 BC loop fills
    them."""
    b = BORDER[order]
    top, left, bottom, right = bc
    g = torch.full((ny + 2 * b, nx + 2 * b), float(ic), dtype=torch.float64,
                   device=device)
    g[:b, :] = bottom
    g[b + ny:, :] = top
    g[:, :b] = left
    g[:, b + nx:] = right
    return g.to(dtype)


def step(u: torch.Tensor, order: int, xcfl: torch.Tensor,
         ycfl: torch.Tensor) -> torch.Tensor:
    """One step of the interior; the bands are left as they are."""
    b = BORDER[order]
    ny, nx = u.shape[0] - 2 * b, u.shape[1] - 2 * b
    coeffs = [torch.tensor(c, dtype=u.dtype) for c in COEFFS[order]]
    accx = coeffs[0] * u[b:b + ny, 0:nx]
    accy = coeffs[0] * u[0:ny, b:b + nx]
    for k in range(1, len(coeffs)):
        accx = accx + coeffs[k] * u[b:b + ny, k:k + nx]
        accy = accy + coeffs[k] * u[k:k + ny, b:b + nx]
    out = u.clone()
    out[b:b + ny, b:b + nx] = u[b:b + ny, b:b + nx] + xcfl * accx + ycfl * accy
    return out


def solve(nx: int, ny: int, order: int, iters: int, ic: float,
          bc: tuple[float, float, float, float], lx: float = 1.0,
          ly: float = 1.0, alpha: float = 1.0, dtype=torch.float32,
          device="cpu") -> torch.Tensor:
    """The final grid of ``iters`` steps from the initial grid, in
    ``dtype`` (the factors rounded to it once)."""
    xc, yc = cfl(order, nx, ny, lx, ly, alpha)
    xcfl = torch.tensor(xc, dtype=dtype)
    ycfl = torch.tensor(yc, dtype=dtype)
    u = initial_grid(nx, ny, order, ic, bc, dtype, device)
    for _ in range(iters):
        u = step(u, order, xcfl, ycfl)
    return u
