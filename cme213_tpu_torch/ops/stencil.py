"""Central-difference heat stencils, orders 2/4/8, in plain PyTorch.

Counterpart of ``cme213_tpu/ops/stencil.py`` (the JAX package's XLA path).
The update is

    u' = u + xcfl * Dxx(u) + ycfl * Dyy(u)

applied to the interior; ``run_heat`` never writes the Dirichlet band.
Taps accumulate in coefficient order, as in the JAX package, and every
product and sum is its own op, rounded on its own: no ``addcmul`` and no
``alpha=`` on ``add``, which would fuse a multiply into an add.  On the CPU
this makes ``run_heat`` bit for bit equal to the numpy golden
(``verify/golden.host_heat``).

These functions run on the tensor's device.  On the card ``run_heat`` is
``apps/heat2d.run_single``'s "global memory" phase, as the XLA path is in
the JAX package; the hand-written kernel is ``ops/stencil_pipeline.py``.
"""

from __future__ import annotations

import torch

# order -> 1-D second-derivative coefficients over offsets [-b..b]
STENCIL_COEFFS = {
    2: (1.0, -2.0, 1.0),
    4: (-1.0, 16.0, -30.0, 16.0, -1.0),
    8: (-9.0, 128.0, -1008.0, 8064.0, -14350.0, 8064.0, -1008.0, 128.0, -9.0),
}

BORDER_FOR_ORDER = {2: 1, 4: 2, 8: 4}


def flops_per_point(order: int) -> int:
    """Flops per grid point per timestep for the given stencil order.

    Per axis: one multiply per tap and one add per accumulation
    (``taps - 1``); the combine ``u + xcfl*accx + ycfl*accy`` adds 2
    multiplies and 2 adds (order 8 → the reference's 38 flops/point).
    """
    taps = len(STENCIL_COEFFS[order])
    return 2 * taps + 2 * (taps - 1) + 4


def _scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    # a 0-d CPU tensor of the grid's dtype: rounds the factor to that type
    # once, as jnp.asarray(value, dtype) does, and works with tensors on
    # any device
    return torch.tensor(value, dtype=dtype)


def stencil_interior(u: torch.Tensor, order: int, xcfl,
                     ycfl) -> torch.Tensor:
    """New interior values (ny, nx) from a full halo grid (gy, gx)."""
    coeffs = STENCIL_COEFFS[order]
    b = BORDER_FOR_ORDER[order]
    gy, gx = u.shape
    ny, nx = gy - 2 * b, gx - 2 * b
    center = u[b:-b, b:-b]
    accx = torch.zeros_like(center)
    accy = torch.zeros_like(center)
    for k, c in enumerate(coeffs):
        c = _scalar(c, u.dtype)
        accx = accx + c * u[b:b + ny, k:k + nx]
        accy = accy + c * u[k:k + ny, b:b + nx]
    return (center + _scalar(xcfl, u.dtype) * accx
            + _scalar(ycfl, u.dtype) * accy)


def stencil_interior_conv(u: torch.Tensor, order: int, xcfl,
                          ycfl) -> torch.Tensor:
    """The update of ``stencil_interior`` as ONE 2-D convolution with a
    cross-shaped (2b+1)² weight (``conv2d``, a cross-correlation as XLA's
    conv is; the weight is symmetric anyway).

    The convolution sums the taps in its own order, so the result agrees
    with ``stencil_interior`` to ~1e-6 relative, not bit for bit: a
    yardstick path, as in the JAX package.  On the card an f32 convolution
    goes through cuDNN in TF32 by default, which keeps about three digits;
    it runs here with TF32 off, the counterpart of the JAX package's
    ``precision=HIGHEST``.
    """
    coeffs = STENCIL_COEFFS[order]
    b = BORDER_FOR_ORDER[order]
    w = 2 * b + 1
    c = torch.tensor(coeffs, dtype=u.dtype)
    kern = torch.zeros(w, w, dtype=u.dtype)
    kern[b, :] += c * _scalar(xcfl, u.dtype)
    kern[:, b] += c * _scalar(ycfl, u.dtype)
    kern[b, b] += _scalar(1.0, u.dtype)  # the center term
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = torch.nn.functional.conv2d(u[None, None],
                                         kern.to(u.device)[None, None])
    return out[0, 0]


def run_heat_conv(u: torch.Tensor, iters: int, order: int, xcfl,
                  ycfl) -> torch.Tensor:
    """``iters`` timesteps of the conv-formulated stencil; returns a new
    grid."""
    b = BORDER_FOR_ORDER[order]
    g = u.clone()
    for _ in range(iters):
        g[b:-b, b:-b] = stencil_interior_conv(g, order, xcfl, ycfl)
    return g


def heat_step(u: torch.Tensor, order: int, xcfl, ycfl) -> torch.Tensor:
    """One timestep: a new grid with the stencil result in the interior."""
    b = BORDER_FOR_ORDER[order]
    out = u.clone()
    out[b:-b, b:-b] = stencil_interior(u, order, xcfl, ycfl)
    return out


def run_heat(u: torch.Tensor, iters: int, order: int, xcfl,
             ycfl) -> torch.Tensor:
    """``iters`` timesteps; returns a new grid, ``u`` is left as it was."""
    b = BORDER_FOR_ORDER[order]
    g = u.clone()
    for _ in range(iters):
        g[b:-b, b:-b] = stencil_interior(g, order, xcfl, ycfl)
    return g


def run_heat_roll(u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
                  bc: tuple[float, float, float, float],
                  k: int = 1) -> torch.Tensor:
    """``iters`` timesteps, full-grid roll formulation.

    Same arithmetic as ``run_heat``, but every tap is a circular
    ``torch.roll`` of the whole grid and the Dirichlet bands
    ``bc = (top, left, bottom, right)`` are re-imposed after every step
    (rows, then columns over the corners: the reference's band order,
    ``2dHeat.cu:326-344``).  Wrapped values land only in the re-imposed
    bands.  On a grid whose bands hold ``bc`` (``make_initial_grid``'s),
    the result equals ``run_heat``'s.  ``iters`` must divide by ``k``, the
    number of steps the hand-written kernel fuses; the result does not
    depend on ``k``.
    """
    if iters % k != 0:
        raise ValueError(f"iters={iters} must divide by k={k}")
    coeffs = [_scalar(c, u.dtype) for c in STENCIL_COEFFS[order]]
    b = BORDER_FOR_ORDER[order]
    xcfl = _scalar(xcfl, u.dtype)
    ycfl = _scalar(ycfl, u.dtype)
    bc_top, bc_left, bc_bottom, bc_right = bc
    gy, gx = u.shape
    rows = torch.arange(gy, device=u.device).view(gy, 1)
    cols = torch.arange(gx, device=u.device).view(1, gx)
    bands = ((rows < b, bc_bottom), (rows >= gy - b, bc_top),
             (cols < b, bc_left), (cols >= gx - b, bc_right))
    g = u
    for _ in range(iters):
        accx = torch.zeros_like(g)
        accy = torch.zeros_like(g)
        for kk, c in enumerate(coeffs):
            accx = accx + c * torch.roll(g, b - kk, 1)
            accy = accy + c * torch.roll(g, b - kk, 0)
        g = g + xcfl * accx + ycfl * accy
        for mask, value in bands:
            g = g.masked_fill(mask, value)
    return g.clone() if g is u else g
