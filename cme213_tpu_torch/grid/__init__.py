from .grid import HaloGrid, interior, make_initial_grid, save_grid_to_file

__all__ = ["HaloGrid", "make_initial_grid", "interior", "save_grid_to_file"]
