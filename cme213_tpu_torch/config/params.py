"""Simulation config: ``params.in``-compatible parsing + CFL/timestep derivation.

A copy of ``cme213_tpu/config/params.py`` (plain Python): the port keeps
its own so that it imports nothing of the JAX package.

Re-expresses the reference's ``simParams`` class
(``hw/hw2/programming/2dHeat.cu:90-228``) as a frozen dataclass with derived
fields.  The distributed variant adds ``grid_method`` (1-D stripes vs 2-D
blocks) and ``synchronous`` (sync vs comm/compute-overlap), matching the hw5
``simParams`` (``hw/hw5/programming/2dHeat.cpp:53-177``, parse at ``:127-135``).

File formats (whitespace-separated, like the reference's ``ifs >>`` parse):

  hw2 (single device, ``hw/hw2/programming/2dHeat.cu:172-178``)::

      nx ny
      lx ly
      alpha
      iters
      order
      ic
      bc_top bc_left bc_bottom bc_right

  hw5 (distributed) inserts ``grid_method`` and ``sync`` between ``ic`` and
  ``bc`` (``hw/hw5/programming/2dHeat.cpp:127-135``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class GridMethod(enum.IntEnum):
    """Domain-decomposition selector (hw5 ``gridMethod_``): 1 = 1-D stripes,
    2 = 2-D blocks (``hw/hw5/programming/2dHeat.cpp:284-377``)."""

    STRIPES_1D = 1
    BLOCKS_2D = 2


_BORDER_FOR_ORDER = {2: 1, 4: 2, 8: 4}


@dataclass(frozen=True)
class SimParams:
    nx: int = 10
    ny: int = 10
    lx: float = 1.0
    ly: float = 1.0
    alpha: float = 1.0
    iters: int = 1000
    order: int = 2
    ic: float = 5.0
    # boundary conditions: 0 top, then counter-clockwise (top, left, bottom,
    # right) — reference ``bc[4]`` comment, ``hw/hw2/programming/2dHeat.cu:128``
    bc_top: float = 0.0
    bc_left: float = 10.0
    bc_bottom: float = 0.0
    bc_right: float = 10.0
    # distributed-only knobs (hw5)
    grid_method: GridMethod = GridMethod.STRIPES_1D
    synchronous: bool = True

    # derived (filled in __post_init__)
    dx: float = field(init=False)
    dy: float = field(init=False)
    dt: float = field(init=False)
    xcfl: float = field(init=False)
    ycfl: float = field(init=False)
    border_size: int = field(init=False)
    gx: int = field(init=False)
    gy: int = field(init=False)

    def __post_init__(self):
        if self.order not in _BORDER_FOR_ORDER:
            raise ValueError(f"Unsupported discretization order {self.order}")
        dx = self.lx / (self.nx - 1)
        dy = self.ly / (self.ny - 1)
        dt, xcfl, ycfl = _calc_dt_cfl(self.order, self.alpha, dx, dy)
        border = _BORDER_FOR_ORDER[self.order]
        object.__setattr__(self, "dx", dx)
        object.__setattr__(self, "dy", dy)
        object.__setattr__(self, "dt", dt)
        object.__setattr__(self, "xcfl", xcfl)
        object.__setattr__(self, "ycfl", ycfl)
        object.__setattr__(self, "border_size", border)
        object.__setattr__(self, "gx", self.nx + 2 * border)
        object.__setattr__(self, "gy", self.ny + 2 * border)

    @classmethod
    def from_file(cls, path: str, distributed: bool = False) -> "SimParams":
        with open(path) as f:
            tok = f.read().split()
        it = iter(tok)
        nx, ny = int(next(it)), int(next(it))
        lx, ly = float(next(it)), float(next(it))
        alpha = float(next(it))
        iters = int(next(it))
        order = int(next(it))
        ic = float(next(it))
        if distributed:
            grid_method = GridMethod(int(next(it)))
            synchronous = bool(int(next(it)))
        else:
            grid_method = GridMethod.STRIPES_1D
            synchronous = True
        bc = [float(next(it)) for _ in range(4)]
        return cls(
            nx=nx, ny=ny, lx=lx, ly=ly, alpha=alpha, iters=iters, order=order,
            ic=ic, bc_top=bc[0], bc_left=bc[1], bc_bottom=bc[2], bc_right=bc[3],
            grid_method=grid_method, synchronous=synchronous,
        )

    def to_file(self, path: str, distributed: bool = False) -> None:
        parts = [
            f"{self.nx} {self.ny}",
            f"{self.lx} {self.ly}",
            f"{self.alpha}",
            f"{self.iters}",
            f"{self.order}",
            f"{self.ic}",
        ]
        if distributed:
            parts.append(f"{int(self.grid_method)}")
            parts.append(f"{int(self.synchronous)}")
        parts.append(
            f"{self.bc_top} {self.bc_left} {self.bc_bottom} {self.bc_right}"
        )
        with open(path, "w") as f:
            f.write("\n".join(parts) + "\n")

    @property
    def bc(self) -> tuple[float, float, float, float]:
        """(top, left, bottom, right)."""
        return (self.bc_top, self.bc_left, self.bc_bottom, self.bc_right)

    def describe(self) -> str:
        """Verbose config echo (reference ``2dHeat.cu:199-202``)."""
        return (
            f"nx: {self.nx} ny: {self.ny}\ngx: {self.gx} gy: {self.gy}\n"
            f"lx {self.lx}: ly: {self.ly}\nalpha: {self.alpha}\n"
            f"iterations: {self.iters}\norder: {self.order}\nic: {self.ic}\n"
            f"dx: {self.dx} dy: {self.dy}\n"
            f"dt: {self.dt} xcfl: {self.xcfl} ycfl: {self.ycfl}"
        )


def _calc_dt_cfl(order: int, alpha: float, dx: float, dy: float):
    """CFL-stable timestep + per-axis CFL numbers.

    Same derivation as the reference's ``simParams::calcDtCFL``
    (``hw/hw2/programming/2dHeat.cu:206-228``): come in just under the 0.5
    stability limit, scale by the order's leading finite-difference
    denominator (1 / 12 / 5040) with center-coefficient factor (2 / 16·2 /
    8064·2 ... expressed exactly as the reference writes it).
    """
    dx2, dy2 = dx * dx, dy * dy
    margin = 0.5 - 0.0001
    if order == 2:
        dt = margin * (dx2 * dy2) / (alpha * (dx2 + dy2))
        return dt, alpha * dt / dx2, alpha * dt / dy2
    if order == 4:
        dt = margin * (12 * dx2 * dy2) / (16 * alpha * (dx2 + dy2))
        return dt, alpha * dt / (12 * dx2), alpha * dt / (12 * dy2)
    if order == 8:
        dt = margin * (5040 * dx2 * dy2) / (8064 * alpha * (dx2 + dy2))
        return dt, alpha * dt / (5040 * dx2), alpha * dt / (5040 * dy2)
    raise ValueError(f"Unsupported discretization order {order}")
