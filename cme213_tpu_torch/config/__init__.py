from .params import GridMethod, SimParams

__all__ = ["SimParams", "GridMethod"]
