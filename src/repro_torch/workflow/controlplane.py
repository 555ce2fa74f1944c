"""Decision helpers shared by the simulator and the real-time loop.

Only ``detect_array_path`` and ``suffix_min_demand`` are ported so far: the
engine imports them.  The control plane proper (``ControlPlane``, the
execution backends) is a later slice of the port.
"""
from __future__ import annotations

import numpy as np


def detect_array_path(scheduler, mode: str = "auto") -> bool:
    """Feature-detect the scheduler side of the array protocol.

    A scheduler serves the array path when it opts in
    (``supports_array_placement``) and exposes both hooks — and, for
    subclasses, when ``select_node`` was not overridden *deeper* in the
    MRO than ``select_node_idx`` (customized dict semantics without an
    array twin must win, not be bypassed).  ``mode="dict"`` forces the
    fallback; ``"array"`` raises instead of silently degrading.
    """
    if mode not in ("auto", "array", "dict"):
        raise ValueError(f"unknown placement_path: {mode!r}")
    if mode == "dict":
        return False
    ok = (getattr(scheduler, "supports_array_placement", False)
          and callable(getattr(scheduler, "select_node_idx", None))
          and callable(getattr(scheduler, "bind_cluster", None)))
    if ok:
        mro = type(scheduler).__mro__
        depth = lambda attr: next(
            (i for i, c in enumerate(mro) if attr in c.__dict__),
            len(mro))
        ok = depth("select_node_idx") <= depth("select_node")
    if not ok and mode == "array":
        raise ValueError(
            f"scheduler {getattr(scheduler, 'name', scheduler)!r} cannot "
            "serve placement_path='array' (no select_node_idx fast path)")
    return ok


def suffix_min_demand(q: list) -> tuple:
    """suffix_rc[i] / suffix_rm[i]: min req_cores / req_mem over q[i:].
    Any task's feasible set is a subset of this joint min-demand's, so
    "no node hosts the min demand" proves the whole suffix blocked."""
    rc = np.fromiter((t.req_cores for t in q), np.int64, len(q))
    rm = np.fromiter((t.req_mem_gb for t in q), np.float64, len(q))
    return (np.minimum.accumulate(rc[::-1])[::-1],
            np.minimum.accumulate(rm[::-1])[::-1])
