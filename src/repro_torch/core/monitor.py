"""Phase 2.1 — dynamic task monitoring (paper §IV-C / §V-A-b).

The paper intercepts Nextflow's ps-based trace and stores per-task resource
usage in PostgreSQL with materialized views.  Here: an in-process trace store
with incrementally-maintained per-(workflow, task, feature) aggregates
(the materialized-view stand-in), JSON-persistable so schedulers across runs
share history (paper A3: workflows are executed repeatedly).
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import json
from collections import defaultdict
from typing import Optional

_DB_UIDS = itertools.count()     # distinguishes store generations (see uid)

TASK_FEATURES = ("cpu", "mem", "io")     # %cores*100, GB resident, MB moved


def _count_sum():
    """Aggregate-cell factory for the materialized views.  Module-level —
    a lambda here would make the store, and every engine snapshot that
    contains one (``Engine.snapshot``), unpicklable."""
    return [0, 0.0]


@dataclasses.dataclass
class TaskTrace:
    workflow: str
    task_name: str                        # abstract task (recurring key)
    instance: str
    run_id: int
    node: str
    runtime_s: float
    usage: dict                           # TASK_FEATURES -> measured value
    tenant: str = "default"               # multi-tenant stream tag


class TraceDB:
    """In-process trace store with incrementally maintained views.

    Fleet-scale notes: runtimes are kept sorted via ``bisect.insort`` so
    ``runtime_quantile`` is an O(1) index instead of an O(n log n) re-sort
    per speculation check; per-workflow task-name sets are cached so
    ``all_usages`` is O(task names) instead of an O(records) rescan; and
    ``version`` is a monotonically increasing history epoch that lets
    schedulers memoize anything derived from the store (labels, usage
    intervals) until the next write.
    """

    def __init__(self):
        self.records: list[TaskTrace] = []
        self.version = 0                  # history epoch, bumped on every add
        # unique per store *generation*: clear() re-runs __init__ and resets
        # version, so external caches must key on (uid, version) — uid alone
        # distinguishes both different TraceDB objects and pre/post-clear
        # states of the same object
        self.uid = next(_DB_UIDS)
        # materialized aggregates: (wf, task, feature) -> [count, total]
        self._agg = defaultdict(_count_sum)
        self._runtime_agg = defaultdict(_count_sum)
        self._runtimes = defaultdict(list)          # kept sorted (insort)
        # per-(wf, task, feature) usage values, append-only on the hot path;
        # sorted lazily on first quantile read after a write (usage
        # quantiles are only consumed by the sizing predictors, so runs
        # with sizing off must not pay a per-add insort)
        self._usages = defaultdict(list)
        self._usages_dirty: set = set()
        self._wf_tasks = defaultdict(set)           # workflow -> task names
        self._usage_cache: dict = {}                # (wf, feature) -> (version, list)
        # runtime-quantile memo: (wf, task, q, method) -> (version, value).
        # The speculation machinery reads the p95 of every running task on
        # every event; between history writes those reads are pure, so one
        # epoch-keyed entry per distinct task name turns the per-event cost
        # into a dict hit (stale entries are overwritten in place, keeping
        # the memo bounded by the distinct key count).
        self._rq_cache: dict = {}

    def __getstate__(self):
        # epoch-keyed memo caches are pure reads rebuilt on demand: drop
        # them from pickles so engine snapshots stay lean
        d = self.__dict__.copy()
        d["_rq_cache"] = {}
        d["_usage_cache"] = {}
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        # re-mint the generation id in the restoring process: external
        # caches key on (uid, version), and a restored store must never
        # collide with a live store that happened to draw the same uid
        self.uid = next(_DB_UIDS)

    # -- writes ---------------------------------------------------------
    def add(self, trace: TaskTrace) -> None:
        self.records.append(trace)
        self.version += 1
        for f in TASK_FEATURES:
            if f in trace.usage:
                a = self._agg[(trace.workflow, trace.task_name, f)]
                a[0] += 1
                a[1] += float(trace.usage[f])
                key = (trace.workflow, trace.task_name, f)
                self._usages[key].append(float(trace.usage[f]))
                self._usages_dirty.add(key)
        r = self._runtime_agg[(trace.workflow, trace.task_name)]
        r[0] += 1
        r[1] += trace.runtime_s
        bisect.insort(self._runtimes[(trace.workflow, trace.task_name)],
                      trace.runtime_s)
        self._wf_tasks[trace.workflow].add(trace.task_name)

    def clear(self) -> None:
        self.__init__()

    # -- reads (the scheduler-facing 'views') ----------------------------
    def has_history(self, workflow: str, task_name: str) -> bool:
        return self._runtime_agg[(workflow, task_name)][0] > 0

    def mean_usage(self, workflow: str, task_name: str, feature: str) -> Optional[float]:
        c, s = self._agg[(workflow, task_name, feature)]
        return (s / c) if c else None

    def mean_runtime(self, workflow: str, task_name: str) -> Optional[float]:
        c, s = self._runtime_agg[(workflow, task_name)]
        return (s / c) if c else None

    @staticmethod
    def _quantile(xs: list, q: float, method: str) -> float:
        """Order statistic over an already-sorted list.

        ``method="seed"`` is the seed implementation's ``int(q*n)`` index —
        max-biased: for q=0.95 it returns the *maximum* of any history of
        20 samples or fewer (``int(0.95*n) == n-1`` whenever n <= 20), so
        early-history speculation fires against the worst run ever seen.
        ``method="linear"`` is the proper linearly-interpolated order
        statistic (numpy's default), which the sizing predictors and the
        ``EngineConfig.quantile_method="linear"`` switch use; the engine
        default stays ``"seed"`` to pin bit-for-bit equivalence.

        The interpolation is numpy's two-sided lerp — ``b - (b-a)*(1-t)``
        once ``t >= 0.5`` — not the naive ``a + t*(b-a)``: the one-sided
        form drifts a ulp from ``numpy.quantile`` on ~2% of inputs, which
        the property suite in ``tests/test_quantiles.py`` pins exactly.
        """
        if method == "seed":
            return xs[min(int(q * len(xs)), len(xs) - 1)]
        if method != "linear":
            raise ValueError(f"unknown quantile method: {method!r}")
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        t = pos - lo
        a, b = xs[lo], xs[hi]
        d = b - a
        return b - d * (1.0 - t) if t >= 0.5 else a + d * t

    def runtime_quantile(self, workflow: str, task_name: str, q: float,
                         method: str = "seed") -> Optional[float]:
        key = (workflow, task_name, q, method)
        hit = self._rq_cache.get(key)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        xs = self._runtimes[(workflow, task_name)]   # maintained sorted
        val = self._quantile(xs, q, method) if xs else None
        self._rq_cache[key] = (self.version, val)
        return val

    def usage_quantile(self, workflow: str, task_name: str, feature: str,
                       q: float, method: str = "linear") -> Optional[float]:
        """Quantile of a task's historic usage values for one feature
        (e.g. the peak-memory distribution the sizing predictors consume).
        Defaults to the corrected linear order statistic."""
        key = (workflow, task_name, feature)
        xs = self._usages[key]
        if not xs:
            return None
        if key in self._usages_dirty:       # lazy: timsort on a mostly-
            xs.sort()                       # sorted list is ~linear
            self._usages_dirty.discard(key)
        return self._quantile(xs, q, method)

    def all_usages(self, workflow: str, feature: str) -> list[float]:
        """Per-task mean usage over this workflow's historic+active tasks,
        the distribution the percentile intervals are applied to (§IV-C).
        Cached per history epoch — labeling hits this once per feature per
        placement decision."""
        key = (workflow, feature)
        hit = self._usage_cache.get(key)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        out = []
        for t in sorted(self._wf_tasks[workflow]):
            u = self.mean_usage(workflow, t, feature)
            if u is not None:
                out.append(u)
        self._usage_cache[key] = (self.version, out)
        return out

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([dataclasses.asdict(r) for r in self.records], f)

    @classmethod
    def load(cls, path: str) -> "TraceDB":
        db = cls()
        with open(path) as f:
            for rec in json.load(f):
                db.add(TaskTrace(**rec))
        return db
