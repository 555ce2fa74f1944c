"""Phases 1.3 + 2.2 — node-group labels and percentile task labels (§IV-B/C).

Node side: groups are ranked per feature (weaker -> lower rank); every node
inherits its group's scalar label vector, values 1..n.

Task side (the paper's formula, verbatim):
    p_0 = 0;  p_i = m_i / sum_k m_k + p_{i-1};  p_n = 1
with m_i the capacity of group i for the feature (CPU -> total cores,
memory -> total GB, I/O -> node count), groups sorted ascending by the
feature's performance score.  The percentiles cut the sorted historic usage
values of the workflow's tasks into n intervals; a task's label is the
1-based interval index of its (mean historic) usage.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from repro_torch.core.monitor import TASK_FEATURES, TraceDB
from repro_torch.core.profiler import NodeProfile

# node-profile feature backing each task label feature
NODE_FEATURE_FOR = {"cpu": "cpu", "mem": "mem", "io": "io_seq_read"}
# node capacity backing the percentile mass of each task feature
def _capacity(profile: NodeProfile, feature: str) -> float:
    if feature == "cpu":
        return float(profile.static.get("cores", 1))
    if feature == "mem":
        return float(profile.static.get("mem_gb", 1.0))
    return 1.0  # io: node count


@dataclasses.dataclass
class GroupInfo:
    """Everything phase 3 needs about the profiled cluster."""
    n_groups: int
    node_group: dict                      # node name -> group idx (0-based)
    group_nodes: dict                     # group idx -> [node names]
    node_labels: dict                     # group idx -> {feature: 1..n}
    group_rank_order: dict                # feature -> [group idx asc by perf]
    group_capacity: dict                  # feature -> {group idx: m_i}
    group_power: dict                     # group idx -> sum of labels

    def labels_vector(self, group: int) -> np.ndarray:
        return np.array([self.node_labels[group][f] for f in TASK_FEATURES],
                        np.float64)

    def member_index_arrays(self, index: dict) -> list:
        """Per-group node-*index* arrays over an engine's node indexing
        (``index``: node name -> array position), for the array-native
        phase-3 fast path: ``allocation.pick_node_idx`` turns the per-group
        Python list-comps of ``pick_node`` into masked gathers over these.

        Built once per index map (identity-keyed memo — schedulers bind one
        cluster for an engine's lifetime) and ordered exactly like
        ``group_nodes``, so tie-break RNG draws happen in the same node
        order as the dict path.
        """
        if getattr(self, "_midx_src", None) is not index:
            self._midx = [
                np.array([index[n] for n in self.group_nodes[g]], np.int64)
                for g in range(self.n_groups)]
            self._midx_src = index
        return self._midx


def build_group_info(profiles: list[NodeProfile], labels) -> GroupInfo:
    labels = np.asarray(labels)
    # k-means can return non-contiguous label ids (choose_k keeps a k whose
    # Lloyd iterations emptied a cluster), and the group machinery below
    # assumes ids 0..n-1 are all populated — an empty id used to feed
    # np.mean an empty list (NaN + RuntimeWarning) and corrupt every rank
    # order downstream.  Compact the ids first: the grouping is identical,
    # only the (arbitrary) group numbering changes.
    uniq = np.unique(labels)                    # sorted populated ids
    if uniq.size != int(labels.max()) + 1:
        labels = np.searchsorted(uniq, labels)  # vectorized rank remap
    n = int(labels.max()) + 1
    node_group = {p.node: int(g) for p, g in zip(profiles, labels)}
    group_nodes = {g: [p.node for p, l in zip(profiles, labels) if l == g]
                   for g in range(n)}

    node_labels = {g: {} for g in range(n)}
    rank_order = {}
    capacity = {}
    for f in TASK_FEATURES:
        nf = NODE_FEATURE_FOR[f]
        means = np.array([np.mean([p.features[nf] for p, l in zip(profiles, labels) if l == g])
                          for g in range(n)])
        order = list(np.argsort(means, kind="stable"))      # weakest first
        rank_order[f] = [int(g) for g in order]
        for rank, g in enumerate(order):
            node_labels[int(g)][f] = rank + 1               # labels 1..n
        capacity[f] = {g: float(sum(_capacity(p, f)
                                    for p, l in zip(profiles, labels) if l == g))
                       for g in range(n)}
    power = {g: float(sum(node_labels[g].values())) for g in range(n)}
    return GroupInfo(n, node_group, group_nodes, node_labels, rank_order,
                     capacity, power)


def percentiles(info: GroupInfo, feature: str) -> list[float]:
    """p_0..p_n per the paper's formula, groups ascending by performance."""
    order = info.group_rank_order[feature]
    caps = [info.group_capacity[feature][g] for g in order]
    total = sum(caps) or 1.0
    ps = [0.0]
    for c in caps[:-1]:
        ps.append(ps[-1] + c / total)
    ps.append(1.0)
    return ps


def usage_intervals(info: GroupInfo, feature: str, usages: list[float]) -> list[float]:
    """Interval bounds [v_{p_1}, ..., v_{p_{n-1}}] from the sorted usage
    distribution (the example in §IV-C: [0,54%[, [54%,112%[, [112%,inf[)."""
    if not usages:
        return []
    xs = sorted(usages)
    ps = percentiles(info, feature)[1:-1]                   # inner cut points
    bounds = []
    for p in ps:
        i = min(int(p * len(xs)), len(xs) - 1)
        bounds.append(xs[i])
    return bounds


def label_from_bounds(value: float, bounds: list[float]) -> int:
    # bounds are non-decreasing (cut points of a sorted distribution), so the
    # 1-based interval index is a bisect: 1 + |{b : b <= value}|
    return 1 + bisect.bisect_right(bounds, value)


def label_task(db: TraceDB, info: GroupInfo, workflow: str, task_name: str):
    """Label vector {feature: 1..n} for a recurring task, or None if the task
    has no history (phase 3 then falls back to fair least-loaded placement)."""
    if not db.has_history(workflow, task_name):
        return None
    out = {}
    for f in TASK_FEATURES:
        usage = db.mean_usage(workflow, task_name, f)
        if usage is None:
            out[f] = 1
            continue
        bounds = usage_intervals(info, f, db.all_usages(workflow, f))
        out[f] = label_from_bounds(usage, bounds)
    return out
