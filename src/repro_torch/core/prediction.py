"""Online runtime/interference prediction for completion-time placement
(Reshi-style, beyond-paper).

Tarema's phase-3 scoring ranks node *groups* by static benchmark scores;
Reshi (arXiv 2208.07905) shows that rank-recommending resources by
*predicted task performance* beats static scoring on heterogeneous
infrastructures.  This module supplies the model: a per (task-label,
node-group) runtime matrix updated incrementally from completed
``AssignmentRecord``s, with a hierarchical cold-start fallback chain
(cell -> label -> group -> global) and a co-residency interference term
fit online from the slowdown the engine's bandwidth-contention model
actually inflicts (``workflow.engine._node_rates``: a node running ``k``
tasks divides memory bandwidth by ``min(1 + beta*(k-1), cap)``; instead
of just suffering that slowdown, the model regresses it from history and
prices it into placement).

Two implementations share every fold and every final arithmetic op:

  * ``IncrementalPredictor`` — the fast production model: running sums
    updated in O(1) per completion, epoch-versioned predictions like the
    ``TraceDB`` caches.
  * ``OraclePredictor`` — the deliberately-slow differential ground
    truth: stores only the raw observation log and recomputes every
    statistic by a full left-to-right replay per query, no incremental
    state.  Because ``_apply`` is the shared fold and float addition is
    replayed in the identical order, the two are **bit-for-bit** equal —
    pinned by the hypothesis differential suite in
    ``tests/test_prediction.py``, the same slow-twin pattern that makes
    ``engine_ref.py`` load-bearing.

The engine hook (``EngineConfig.prediction``) records a completion-time
prediction for every placement (so error is measurable for *any*
scheduler, not only the predictive one) and feeds completed attempts
back into the model; killed/partial attempts never train it.  Default is
off and bit-for-bit seed-equivalent.

``error_report`` reduces an engine's ``prediction_log`` into the numbers
the model is judged by — MAPE overall, cold vs warm (cell-level history
vs fallback predictions), and per label x group — per the
prediction-survey guidance (arXiv 2504.20867) that model comparisons are
only trustworthy with held-out error measurement.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

MODELS = ("incremental", "oracle")

# fallback chain, most to least specific (cold-start levels)
LEVELS = ("cell", "label", "group", "global")


@dataclasses.dataclass
class PredictionConfig:
    """Engine-facing prediction knobs (``EngineConfig.prediction``).

    ``model`` selects the implementation ("oracle" exists for the
    differential harness, not for production use); ``theta_max`` clamps
    the fitted interference slope and ``factor_cap`` ceilings the
    predicted slowdown factor — it mirrors the engine's ``mem_cap``
    (``MEM_SHARE_CAP``), past which contention saturates in the
    simulation too.
    """
    model: str = "incremental"
    theta_max: float = 4.0
    factor_cap: float = 8.0

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"unknown prediction model: {self.model!r}")
        if self.theta_max < 0.0:
            raise ValueError("theta_max must be >= 0")
        if self.factor_cap < 1.0:
            raise ValueError("factor_cap must be >= 1 (a slowdown factor)")


class PredictionRecord(NamedTuple):
    """One placement's prediction, finalized at completion
    (``Engine.prediction_log``).  ``predicted_s`` is the full completion
    estimate (base runtime x interference factor) at placement time, or
    None when the model was completely cold (``level == "none"``);
    ``co_res`` counts co-resident attempts on the node at start,
    including this one."""
    instance: str
    workflow: str
    task: str
    node: str
    group: int
    predicted_s: Optional[float]
    level: str
    co_res: int
    actual_s: float


class _Stats:
    """Running sums of the observation fold — the *whole* model state.

    Kept deliberately primitive (dicts of [count, total] plus four
    scalars) so the incremental accumulation and the oracle's replay are
    the same float-addition sequence: bit-for-bit equality between the
    two implementations is a property of this container, not a test
    tolerance."""

    __slots__ = ("cell", "label", "group", "n", "total", "sxx", "sxy")

    def __init__(self):
        self.cell: dict = {}     # (wf, task, group) -> [count, total_s]
        self.label: dict = {}    # (wf, task) -> [count, total_s]
        self.group: dict = {}    # group -> [count, total_s]
        self.n = 0               # global count
        self.total = 0.0         # global total_s
        self.sxx = 0.0           # interference regression: sum x*x
        self.sxy = 0.0           #                          sum x*(r-1)

    # _Stats has __slots__, so pickling (engine snapshot) needs the pair
    def __getstate__(self):
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, d):
        for s in self.__slots__:
            setattr(self, s, d[s])


def _apply(st: _Stats, workflow: str, task: str, group: int,
           runtime_s: float, co_res: int) -> None:
    """Fold one completed observation into ``st``.

    The interference sample is taken *before* the mean update, against
    the cell mean the predictor would have used at placement time — so a
    replay from scratch reproduces the incremental sums exactly."""
    ck = (workflow, task, group)
    c = st.cell.get(ck)
    if c is not None:
        base = c[1] / c[0]
        x = float(co_res - 1)
        if x > 0.0 and base > 0.0:
            r = runtime_s / base
            st.sxx += x * x
            st.sxy += x * (r - 1.0)
        c[0] += 1
        c[1] += runtime_s
    else:
        st.cell[ck] = [1, runtime_s]
    lk = (workflow, task)
    l = st.label.get(lk)
    if l is not None:
        l[0] += 1
        l[1] += runtime_s
    else:
        st.label[lk] = [1, runtime_s]
    g = st.group.get(group)
    if g is not None:
        g[0] += 1
        g[1] += runtime_s
    else:
        st.group[group] = [1, runtime_s]
    st.n += 1
    st.total += runtime_s


def _theta(st: _Stats, cfg: PredictionConfig) -> float:
    """Least-squares slope of (runtime ratio - 1) over (co-residents - 1),
    clamped to [0, theta_max] — contention can only slow tasks down."""
    if st.sxx <= 0.0:
        return 0.0
    th = st.sxy / st.sxx
    if th < 0.0:
        return 0.0
    return th if th < cfg.theta_max else cfg.theta_max


def _predict_from(st: _Stats, workflow: str, task: str, group: int):
    """Hierarchical base-runtime estimate: (seconds, level) or None.

    cell   — mean of this (task, group) cell;
    label  — task mean across groups, scaled by the group's speed ratio
             (group mean / global mean) when the group has history;
    group  — group mean across tasks (task never seen at all);
    global — grand mean (only the task's group is completely unseen);
    None   — no observation anywhere (caller falls back to fair).
    """
    c = st.cell.get((workflow, task, group))
    if c is not None:
        return c[1] / c[0], "cell"
    l = st.label.get((workflow, task))
    if l is not None:
        base = l[1] / l[0]
        g = st.group.get(group)
        if g is not None and st.n > 0:
            gmean = g[1] / g[0]
            amean = st.total / st.n
            if amean > 0.0:
                return base * (gmean / amean), "label"
        return base, "label"
    g = st.group.get(group)
    if g is not None:
        return g[1] / g[0], "group"
    if st.n > 0:
        return st.total / st.n, "global"
    return None


class RuntimePredictor:
    """Shared query surface; subclasses only decide how ``_stats`` is
    materialized (running state vs full replay)."""

    kind = "base"

    def __init__(self, cfg: PredictionConfig):
        self.cfg = cfg
        self.version = 0          # epoch: bumped once per observation

    # -- implementation surface -------------------------------------------
    def _stats(self) -> _Stats:
        raise NotImplementedError

    def observe(self, workflow: str, task: str, group: int,
                runtime_s: float, co_res: int) -> None:
        raise NotImplementedError

    # -- queries -----------------------------------------------------------
    def predict(self, workflow: str, task: str, group: int):
        """(base runtime seconds, fallback level) or None when cold."""
        return _predict_from(self._stats(), workflow, task, int(group))

    def theta(self) -> float:
        return _theta(self._stats(), self.cfg)

    def interference(self, co_res: int) -> float:
        """Predicted slowdown factor for ``co_res`` co-resident attempts
        (including the predicted one)."""
        x = co_res - 1
        if x <= 0:
            return 1.0
        f = 1.0 + self.theta() * float(x)
        return f if f < self.cfg.factor_cap else self.cfg.factor_cap

    def placement_scores(self, workflow: str, task: str, groups, n_running):
        """Predicted completion seconds per candidate node, or None when
        the model is completely cold.

        ``groups``/``n_running`` are aligned per-candidate sequences (the
        node's group id and its running-task count *before* this
        placement).  One ``_stats`` materialization serves the whole
        pass — for the oracle that is exactly one replay per placement —
        and the per-candidate arithmetic is plain scalar float ops so the
        dict and array scheduler paths are bit-for-bit identical.
        """
        st = self._stats()
        th = _theta(st, self.cfg)
        cap = self.cfg.factor_cap
        out = np.empty(len(groups), np.float64)
        for i in range(len(groups)):
            p = _predict_from(st, workflow, task, int(groups[i]))
            if p is None:
                return None     # group-independent: cold for one == all
            f = 1.0 + th * float(n_running[i])
            if f > cap:
                f = cap
            out[i] = p[0] * f
        return out


class IncrementalPredictor(RuntimePredictor):
    """Production model: O(1) folds, epoch-memoized predictions."""

    kind = "incremental"

    def __init__(self, cfg: PredictionConfig):
        super().__init__(cfg)
        self.stats = _Stats()
        self._cache: dict = {}    # (wf, task, group, version) -> prediction

    def __getstate__(self):
        # snapshot leanness: the memo is an epoch-keyed pure read
        d = self.__dict__.copy()
        d["_cache"] = {}
        return d

    def _stats(self) -> _Stats:
        return self.stats

    def observe(self, workflow, task, group, runtime_s, co_res):
        _apply(self.stats, workflow, task, int(group), float(runtime_s),
               int(co_res))
        self.version += 1

    def predict(self, workflow, task, group):
        key = (workflow, task, int(group), self.version)
        hit = self._cache.get(key)
        if hit is None and key not in self._cache:
            if len(self._cache) > 65536:          # epoch churn backstop
                self._cache.clear()
            hit = _predict_from(self.stats, workflow, task, int(group))
            self._cache[key] = hit
        return hit


class OraclePredictor(RuntimePredictor):
    """Differential ground truth: no incremental state whatsoever.

    Every query replays the full observation log through the shared
    ``_apply`` fold, left to right, from zero.  Deliberately O(history)
    per query — its only job is to make the fast model's correctness a
    bit-for-bit property instead of a tolerance."""

    kind = "oracle"

    def __init__(self, cfg: PredictionConfig):
        super().__init__(cfg)
        self.log: list = []       # (wf, task, group, runtime_s, co_res)

    def observe(self, workflow, task, group, runtime_s, co_res):
        self.log.append((workflow, task, int(group), float(runtime_s),
                         int(co_res)))
        self.version += 1

    def _stats(self) -> _Stats:
        st = _Stats()
        for obs in self.log:
            _apply(st, *obs)
        return st


_PREDICTORS = {"incremental": IncrementalPredictor, "oracle": OraclePredictor}


def make_predictor(cfg: PredictionConfig) -> RuntimePredictor:
    return _PREDICTORS[cfg.model](cfg)


# ------------------------------------------------------------ error report
def error_report(records) -> dict:
    """Reduce a ``prediction_log`` into MAPE columns.

    warm = cell-level predictions (the (task, group) cell had history);
    cold = every fallback level, including "none" (no prediction at all —
    counted, excluded from MAPE).  ``per_cell`` keys are "task|g<group>".
    """
    scored = [r for r in records
              if r.predicted_s is not None and r.actual_s > 0.0]
    ape = np.array([abs(r.predicted_s - r.actual_s) / r.actual_s
                    for r in scored], np.float64)
    warm = np.array([r.level == "cell" for r in scored], bool)
    per_cell: dict = {}
    for r, e in zip(scored, ape):
        key = f"{r.task}|g{r.group}"
        agg = per_cell.setdefault(key, {"n": 0, "sum_ape": 0.0})
        agg["n"] += 1
        agg["sum_ape"] += float(e)
    out_cells = {k: {"n": v["n"], "mape": v["sum_ape"] / v["n"]}
                 for k, v in sorted(per_cell.items())}
    def _mape(sel):
        return float(ape[sel].mean()) if ape[sel].size else None
    return {
        "n_records": len(records),
        "n_scored": len(scored),
        "n_cold_none": sum(1 for r in records if r.predicted_s is None),
        "mape": float(ape.mean()) if ape.size else None,
        "mape_warm": _mape(warm),
        "mape_cold": _mape(~warm),
        "n_warm": int(warm.sum()),
        "n_cold": int((~warm).sum()) + sum(1 for r in records
                                           if r.predicted_s is None),
        "per_cell": out_cells,
    }
