"""Phase 3 — adaptive resource allocation (paper §IV-D).

Score for a node-group/task pair:  f(n, t) = sum_k |n_k - t_k| over the
feature labels.  The minimum-score feasible group wins; ties break to the
most powerful group (largest label sum); inside a group the least-loaded
node wins; unlabeled tasks go to the least-loaded feasible node overall.

``score_matrix`` is the vectorised (torch) form used both here and by the
fleet-placement layer (many tasks x many groups at once); it runs on the
scheduler's device (``device``, default CUDA: see ``repro_torch.device``).
The scores are sums of absolute differences of small integers, so they
equal the reference's exactly, on either device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.labeling import GroupInfo
from repro_torch.core.monitor import TASK_FEATURES
from repro_torch.device import resolve_device


def score_matrix(group_labels, task_labels, device=None) -> torch.Tensor:
    """group_labels: (G, q); task_labels: (T, q) -> float32 scores (T, G)
    on ``device``."""
    dev = resolve_device(device)
    g = torch.as_tensor(np.asarray(group_labels, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(task_labels, np.float32), device=dev)
    return torch.abs(t[:, None, :] - g[None, :, :]).sum(-1)


def task_scores(info: GroupInfo, task_labels: dict,
                device=None) -> np.ndarray:
    """Per-group float32 scores of one task's label vector (shared formula
    source; one device dispatch — schedulers memoize the result per label
    vector)."""
    t = np.array([task_labels[f] for f in TASK_FEATURES], np.float64)
    g = np.stack([info.labels_vector(gi) for gi in range(info.n_groups)])
    return score_matrix(g, t[None], device).cpu().numpy()[0]


def _rank_groups(info: GroupInfo, scores) -> list[int]:
    """(score asc, power desc) — the paper's priority ordering."""
    return sorted(range(info.n_groups),
                  key=lambda gi: (scores[gi], -info.group_power[gi]))


def priority_groups(info: GroupInfo, task_labels: dict,
                    device=None) -> list[int]:
    """Groups ordered by (score asc, power desc) — the paper's priority list."""
    return _rank_groups(info, task_scores(info, task_labels, device))


def weighted_priority_groups(info: GroupInfo, task_labels: dict,
                             overuse: float, pressure: float = 1.0,
                             base_scores: np.ndarray | None = None,
                             device=None) -> list[int]:
    """Tenant-aware variant of ``priority_groups`` (multi-tenant phase 3).

    ``overuse`` is how far the task's tenant currently sits above its
    weighted fair share of the cluster (<= 0 means at or under share, which
    delegates to the paper's ordering unchanged).  An over-share tenant has
    every group's score inflated proportionally to the group's power,
    steering it toward weaker groups and leaving the strong ones for
    under-served tenants.  ``base_scores`` lets the caller supply a
    memoized ``task_scores`` result (it is overuse-independent) so the hot
    path only pays the cheap numpy penalty + sort.
    """
    if overuse <= 0.0:
        return priority_groups(info, task_labels, device)
    if base_scores is None:
        base_scores = task_scores(info, task_labels, device)
    power = np.array([info.group_power[gi] for gi in range(info.n_groups)])
    scores = base_scores + pressure * overuse * power
    return _rank_groups(info, scores)


def node_loads(na, cand: np.ndarray) -> np.ndarray:
    """Load metric of candidate node indices ``cand`` over the engine's
    node SoA ``na`` — the single array-side source of the formula, mirroring
    ``SimNode.load()`` operand-for-operand
    (``0.5 * ((1 - free_cores/cores) + (1 - free_mem/mem))``) so every
    array-path argmin is bit-for-bit the dict path's choice."""
    return 0.5 * ((1.0 - na.free_cores[cand] / na.cores[cand])
                  + (1.0 - na.free_mem[cand] / na.mem_gb[cand]))


def least_loaded_idx(na, cand: np.ndarray, rng=None) -> int:
    """Least-loaded node among candidate indices ``cand``, ties broken by
    one RNG draw per candidate — the array twin of
    ``min(cands, key=lambda n: (load[n], rng.random()))``; np.lexsort is
    stable, matching Python ``min``'s first-of-equals tie-break."""
    ties = rng.random(cand.size) if rng is not None \
        else np.zeros(cand.size, np.float64)
    return int(cand[np.lexsort((ties, node_loads(na, cand)))[0]])


def pick_node_idx(info: GroupInfo, task_labels, na, mask: np.ndarray,
                  rng=None, priority=None, device=None) -> int | None:
    """Array-native twin of ``pick_node``: a masked argmin per priority
    group over the engine's node SoA instead of per-group Python list-comps
    and a dict of loads.  ``mask`` is the per-task feasibility bitmap over
    node indices; returns a node index or None.  RNG draw counts and order
    match ``pick_node`` exactly (one draw per feasible candidate of the
    first non-empty group, in ``group_nodes`` order), so both paths consume
    identical random streams.
    """
    if task_labels is None:         # unknown task -> fair: least-loaded overall
        cand = np.flatnonzero(mask)
        return least_loaded_idx(na, cand, rng) if cand.size else None
    members = info.member_index_arrays(na.index)
    for g in (priority if priority is not None
              else priority_groups(info, task_labels, device)):
        sub = members[g]
        cand = sub[mask[sub]]
        if cand.size:
            return least_loaded_idx(na, cand, rng)
    return None


def pick_node(info: GroupInfo, task_labels, node_load, feasible,
              rng=None, priority=None, device=None) -> str | None:
    """node_load: node -> load metric (lower = freer); feasible: node -> bool.
    Returns the chosen node name or None if nothing is feasible.  Load ties
    break randomly (rng) so list order never leaks into placement.
    ``priority`` optionally supplies a precomputed `priority_groups` result
    (the scheduler memoizes it per label vector — the score matrix is
    dispatch-bound at one call per placement)."""
    tie = (lambda: rng.random()) if rng is not None else (lambda: 0.0)
    if task_labels is None:         # unknown task -> fair: least-loaded overall
        cands = [n for n, ok in feasible.items() if ok]
        return min(cands, key=lambda n: (node_load[n], tie())) if cands else None
    for g in (priority if priority is not None
              else priority_groups(info, task_labels, device)):
        cands = [n for n in info.group_nodes[g] if feasible.get(n)]
        if cands:
            return min(cands, key=lambda n: (node_load[n], tie()))
    return None
