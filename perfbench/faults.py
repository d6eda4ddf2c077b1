"""Faults planted under the timed path, for the harness's own tests: each
must turn ``correct`` false.  ``PERFBENCH_FAULT`` names one; the harness
installs it before set-up (in a gang, in every rank).  The benchmark's
runs never set it.

- ``unchanged``: the solve returns the state it was given;
- ``altered``: one value of the answer is changed where it is produced;
- ``no-exchange``: the halo exchange between ranks is left out.
"""

from __future__ import annotations

import os

FAULT_ENV = "PERFBENCH_FAULT"


def _heat(fault: str) -> None:
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    real = sp.run_heat_resilient

    def planted(u, *args, **kwargs):
        res = real(u, *args, **kwargs)
        if fault == "unchanged":
            res.value = u.clone()
        else:
            res.value[u.shape[0] // 2, u.shape[1] // 2] += 1.0
        return res

    sp.run_heat_resilient = planted


def _spmv(fault: str) -> None:
    from cme213_tpu_torch.apps import spmv_scan

    real = spmv_scan.run_spmv_scan

    def planted(prob, *args, **kwargs):
        out = real(prob, *args, **kwargs)
        if fault == "unchanged":
            return prob.a.copy()
        out[out.shape[0] // 2] += 1.0
        return out

    spmv_scan.run_spmv_scan = planted


def _dist(fault: str) -> None:
    from cme213_tpu_torch.dist import halo, heat

    if fault == "no-exchange":
        def no_exchange(lines, halos, border, dim, owners):
            # every halo that a peer would send stays as allocated: zeros
            import torch

            from cme213_tpu_torch.dist.multihost import process_info

            for op, _, li, i, side in halo.exchange_plan(
                    owners, process_info()[0]):
                if op == "recv":
                    blk = lines[li][i]
                    shape = list(blk.shape)
                    shape[dim] = border
                    halos[li][i][side] = torch.zeros(
                        shape, dtype=blk.dtype, device=blk.device)

        halo._exchange_batched = no_exchange
        return
    real = heat.run_distributed_heat

    def planted(params, *args, **kwargs):
        out = real(params, *args, **kwargs)
        if fault == "unchanged":
            from cme213_tpu_torch.grid import make_initial_grid

            return make_initial_grid(params, device="cpu").numpy()
        out[out.shape[0] // 2, out.shape[1] // 2] += 1.0
        return out

    heat.run_distributed_heat = planted


PLANTERS = {"heat_single": _heat, "spmv_scan": _spmv, "hw5_gang": _dist}
#: the faults each driver's timed path can have
FAULTS = {"heat_single": ("unchanged", "altered"),
          "spmv_scan": ("unchanged", "altered"),
          "hw5_gang": ("unchanged", "altered", "no-exchange")}


_INSTALLED: set = set()


def install_from_env(driver: str) -> None:
    """Plant the fault that ``PERFBENCH_FAULT`` names, once a process."""
    fault = os.environ.get(FAULT_ENV)
    if fault and driver not in _INSTALLED:
        _INSTALLED.add(driver)
        PLANTERS[driver](fault)
