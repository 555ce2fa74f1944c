"""Carry state across from the reference package into the port.

In this system the monitoring history and the node groups play the part
that weights play in a model: a scheduler's decisions follow from them.
These functions rebuild the port's objects from plain data — JSON rows,
dicts, numpy arrays — and never take an object of the reference package,
so the port needs none of it to load what the reference wrote.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.monitor import TaskTrace, TraceDB
from repro_torch.core.profiler import NodeProfile, NodeSpec


def tracedb_from_records(records: list[dict]) -> TraceDB:
    """A TraceDB from the rows ``TraceDB.save`` writes (one dict per
    ``TaskTrace``), added in order so every derived view matches."""
    db = TraceDB()
    for rec in records:
        db.add(TaskTrace(**rec))
    return db


def specs_from_dicts(rows: list[dict]) -> list[NodeSpec]:
    """NodeSpecs from ``dataclasses.asdict`` rows."""
    return [NodeSpec(**row) for row in rows]


def profiles_from_dicts(rows: list[dict]) -> list[NodeProfile]:
    """NodeProfiles from dicts with keys node, machine, features, static."""
    return [NodeProfile(row["node"], row["machine"], dict(row["features"]),
                        dict(row["static"])) for row in rows]


def grouping_from_arrays(k: int, labels, centers, silhouette: float) -> dict:
    """A grouping in ``choose_k``'s return format, from arrays the
    reference computed (its per-k scores are not carried)."""
    return {"k": int(k), "labels": np.asarray(labels, np.int32),
            "centers": np.asarray(centers),
            "silhouette": float(silhouette), "per_k": {}}
