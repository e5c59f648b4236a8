"""Warm-start checkpointing: persist solver state across processes.

The reference has no file checkpointing; its checkpoint/resume equivalent is
the caller-visible warm-start state `sip_workspace.vars.{x,y}` that persists
across solve() calls (reference: tests/variable_dimensions_test.cpp:437-446,
SURVEY section 5).  Here that state is an explicit pytree (Primal, YVec), so
persisting it is a plain array dump: save the primal/dual iterates of a
(possibly batched) solve to one ``.npz`` file and resume a receding-horizon
MPC loop in a fresh process — the "checkpoint/resume" for this
domain.
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import numpy as np

from ..solver.sip import Primal, YVec

_FIELDS = ("x", "u", "theta", "y_dyn", "y_nc", "y_ec")


def save_warm_start(path: str, vars: Primal, y: YVec) -> None:
    """Write warm-start state (batched or not) to ``path`` (.npz).

    Accepts device or host arrays; everything is pulled to host.
    """
    vars, y = jax.device_get((vars, y))
    arrays = dict(x=vars.x, u=vars.u, theta=vars.theta,
                  y_dyn=y.dyn, y_nc=y.nc, y_ec=y.ec)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)  # atomic publish: no torn checkpoint on crash


def load_warm_start(path: str) -> Tuple[Primal, YVec]:
    """Load state saved by :func:`save_warm_start`.

    Returns host NumPy arrays; pass them straight to
    ``solve(problem, settings, init_vars=vars, init_y=y)`` (JAX will place
    them on device at the jit boundary).
    """
    with np.load(path) as data:
        missing = [k for k in _FIELDS if k not in data]
        if missing:
            raise ValueError(
                f"{path} is not a warm-start checkpoint: missing {missing}")
        vars = Primal(x=data["x"], u=data["u"], theta=data["theta"])
        y = YVec(dyn=data["y_dyn"], nc=data["y_nc"], ec=data["y_ec"])
    return vars, y
