"""Distributed execution: meshes, halos, the sharded heat solve and scan,
the gang (multi-process start-up, launcher, supervision) and its
epoch-committed checkpoints.  Public names resolve on first access (PEP
562), so importing ``dist.supervisor`` or ``dist.launch`` does not import
``torch``."""

from importlib import import_module

#: public name -> the submodule that defines it
_NAMES = {
    "Mesh": "mesh", "make_mesh_1d": "mesh", "make_mesh_2d": "mesh",
    "mesh_for_method": "mesh",
    "distributed_heat_step": "heat", "prepare_distributed_heat": "heat",
    "run_distributed_heat": "heat",
    "run_distributed_heat_supervised": "heat",
    "distributed_segmented_scan": "scan",
    "make_iterated_sharded_scan": "scan",
    "make_iterated_sharded_scan_gated": "scan", "shard_1d": "scan",
}

__all__ = list(_NAMES)


def __getattr__(name: str):
    if name in _NAMES:
        return getattr(import_module(f".{_NAMES[name]}", __name__), name)
    try:  # a submodule, imported on first access
        return import_module(f".{name}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
