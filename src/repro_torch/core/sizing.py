"""Online task memory sizing with OOM-retry semantics (beyond-paper).

Tarema's monitor measures per-task peak memory (``TaskTrace.usage["mem"]``)
but the paper's engine still reserves the static 2-CPU/5-GB request for every
instance, so the cluster operates permanently in the over-/under-sizing
regime that dominates real deployments: over-sized requests strand memory
that could host more tasks, under-sized requests OOM and burn retry time.
This module supplies the missing subsystem — pluggable *online* memory
predictors driven off exactly the epoch-versioned history ``TraceDB``
already maintains, in the style of Ponder's failure-aware prediction
(arXiv 2408.00047) and the task-performance-prediction survey
(arXiv 2504.20867):

  * ``StaticSizer`` — the seed default: always request the workflow spec's
    ``req_mem_gb`` (the paper's 5 GB).  With sizing enabled this baseline
    *does* run under OOM semantics (a 5-GB request genuinely under-sizes
    the heaviest nf-core instances), which is precisely the blind spot the
    static protocol hides.
  * ``PercentileSizer`` — request a high quantile of the task's historic
    peak-memory distribution plus a relative safety offset, falling back to
    the static request until history exists.  Uses the *corrected* linear
    order statistic (``TraceDB.usage_quantile(..., method="linear")``), not
    the seed's max-biased ``int(q*n)`` index.
  * ``EscalationSizer`` — Ponder-style: deliberately start low (a median
    prediction, or a fraction of the static request when no history
    exists), escalate multiplicatively on OOM failure, and remember per
    (workflow, task) failure floors so future instances skip the requests
    that already failed.

The engine (``EngineConfig.sizing``) runs tasks under the *sized*
``req_mem_gb``, raises an OOM failure event when the sampled peak usage
exceeds the sized request, retries with an escalated request (logging every
attempt to ``assignment_log`` with ``completed=False``), and cancels the
downstream subtree when ``max_retries`` is exhausted.  Default is off and
bit-for-bit seed-equivalent.

``wastage_report`` reduces an assignment log into the numbers the trade-off
is judged by — allocated-minus-used GB-seconds, OOM retry counts, and retry
overhead time — with the same vectorized ``np.bincount``-over-factorized-
codes passes as ``repro_torch.core.fairness``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.monitor import TraceDB

STRATEGIES = ("static", "percentile", "escalation")


@dataclasses.dataclass
class SizingConfig:
    """Engine-facing sizing knobs (``EngineConfig.sizing``).

    ``strategy`` selects the predictor; ``quantile``/``safety`` shape the
    percentile prediction; ``start_fraction``/``start_quantile`` shape the
    escalation strategy's deliberately-low first request;
    ``escalation_factor`` multiplies the failed request on every OOM retry
    and ``max_retries`` bounds the retries before the instance fails
    permanently; ``min_gb`` floors any prediction; ``oom_progress`` bounds
    the work fraction at which an under-sized attempt hits its peak (the
    exact point is deterministic per instance id).
    """
    strategy: str = "percentile"
    quantile: float = 0.95            # percentile strategy: historic peak q
    safety: float = 0.10              # relative safety offset on predictions
    start_fraction: float = 0.5       # escalation: first request w/o history
    start_quantile: float = 0.5       # escalation: historic quantile to start
    escalation_factor: float = 2.0    # OOM retry request multiplier
    max_retries: int = 3              # OOM retries before permanent failure
    min_gb: float = 0.25              # floor for any sized request
    oom_progress: tuple = (0.35, 0.9)  # OOM point, fraction of task work

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown sizing strategy: {self.strategy!r}")
        if not self.escalation_factor > 1.0:
            raise ValueError("escalation_factor must be > 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        lo, hi = self.oom_progress
        if not (0.0 < lo <= hi <= 1.0):
            raise ValueError("oom_progress must satisfy 0 < lo <= hi <= 1 "
                             "(an attempt cannot OOM past its own work)")
        for name in ("quantile", "start_quantile"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1]")
        if self.start_fraction <= 0.0 or self.min_gb <= 0.0:
            raise ValueError("start_fraction and min_gb must be > 0")


class MemorySizer:
    """Base predictor: the seed-static request, escalate-on-OOM semantics.

    ``predict`` returns the initial (attempt-0) request for a task instance
    given its history; ``escalate`` the next request after an OOM at
    ``failed_req``; ``observe_oom`` lets failure-aware strategies learn
    across instances.  Predictions are memoized per (workflow, task,
    history epoch) — ``TraceDB.version``-keyed like the schedulers' label
    caches — so re-sizing the queue every scheduling pass stays a dict hit.
    """

    name = "static"

    def __init__(self, cfg: SizingConfig):
        self.cfg = cfg
        self._cache: dict = {}

    def __getstate__(self):
        # snapshot leanness (Engine.snapshot): the memo is dead weight in a
        # pickle anyway — it keys on db.uid, which TraceDB re-mints on
        # restore, so no restored entry could ever hit
        d = self.__dict__.copy()
        d["_cache"] = {}
        return d

    # -- strategy surface -------------------------------------------------
    def _predict_uncached(self, db: TraceDB, workflow: str, task_name: str,
                          base_req: float) -> float:
        return base_req

    def observe_oom(self, workflow: str, task_name: str,
                    failed_req: float) -> None:
        pass

    def escalate(self, db: TraceDB, workflow: str, task_name: str,
                 failed_req: float) -> float:
        return failed_req * self.cfg.escalation_factor

    # -- shared entry point ----------------------------------------------
    def predict(self, db: TraceDB, workflow: str, task_name: str,
                base_req: float) -> float:
        key = (workflow, task_name, base_req, db.uid, db.version)
        hit = self._cache.get(key)
        if hit is None:
            if len(self._cache) > 65536:          # epoch churn backstop
                self._cache.clear()
            hit = max(self.cfg.min_gb,
                      self._predict_uncached(db, workflow, task_name,
                                             base_req))
            self._cache[key] = hit
        return hit


class StaticSizer(MemorySizer):
    """Seed default: always the workflow spec's static request."""
    name = "static"


class PercentileSizer(MemorySizer):
    """Percentile-of-history + safety offset; static until history exists.

    Uses the corrected linear-interpolation order statistic — the seed's
    ``int(q*n)`` index returns the *maximum* for q=0.95 on any history of
    20 samples or fewer, which would quietly turn this into max+offset.
    """
    name = "percentile"

    def _predict_uncached(self, db, workflow, task_name, base_req):
        q = db.usage_quantile(workflow, task_name, "mem", self.cfg.quantile,
                              method="linear")
        if q is None:
            return base_req
        return q * (1.0 + self.cfg.safety)


class EscalationSizer(MemorySizer):
    """Ponder-style failure-escalation: start low, escalate on OOM, and
    remember per-task failure floors so future instances start above every
    request that has already OOM'd."""
    name = "escalation"

    def __init__(self, cfg: SizingConfig):
        super().__init__(cfg)
        self._floor: dict = {}        # (workflow, task) -> failed request

    def _predict_uncached(self, db, workflow, task_name, base_req):
        q = db.usage_quantile(workflow, task_name, "mem",
                              self.cfg.start_quantile, method="linear")
        guess = base_req * self.cfg.start_fraction if q is None \
            else q * (1.0 + self.cfg.safety)
        floor = self._floor.get((workflow, task_name))
        if floor is not None:
            guess = max(guess, floor * self.cfg.escalation_factor)
        return guess

    def observe_oom(self, workflow, task_name, failed_req):
        key = (workflow, task_name)
        self._floor[key] = max(self._floor.get(key, 0.0), failed_req)
        self._cache.clear()           # floors invalidate memoized predictions


_SIZERS = {"static": StaticSizer, "percentile": PercentileSizer,
           "escalation": EscalationSizer}


def make_sizer(cfg: SizingConfig) -> MemorySizer:
    return _SIZERS[cfg.strategy](cfg)


# ---------------------------------------------------------------- wastage
@dataclasses.dataclass
class WastageReport:
    """Memory-sizing outcome of one engine run's assignment log.

    GB-second integrals are over each attempt's wall interval; ``wastage``
    is allocated minus used (negative means the static request under-sized
    the task and it ran overcommitted — only possible with sizing off,
    where nothing enforces the request).  OOM retry overhead is the wall
    time burned by killed attempts — the cost column that static-request
    protocols silently drop.
    """
    n_records: int
    n_completed: int
    allocated_gb_s: float
    used_gb_s: float
    wastage_gb_s: float
    oom_kills: int                    # OOM'd attempts (retried or final)
    oom_failures: int                 # instances that exhausted max_retries
    retry_overhead_s: float           # wall time of OOM'd attempts only
                                      # (node-failure/speculative kill time
                                      # is not a sizing cost)
    per_tenant: dict                  # tenant -> {allocated/used/wastage_gb_s}

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def wastage_report(records) -> WastageReport:
    """Vectorized reduction of an assignment log (see ``fairness.py`` for
    the idiom): one pass to arrays, ``np.bincount`` over factorized tenant
    codes for the per-tenant split."""
    if not records:
        return WastageReport(0, 0, 0.0, 0.0, 0.0, 0, 0, 0.0, {})
    from repro_torch.core.fairness import _factorize
    dur = (np.array([r.end for r in records], np.float64)
           - np.array([r.start for r in records], np.float64))
    alloc = np.array([r.mem_gb for r in records], np.float64) * dur
    used = np.array([r.used_mem_gb for r in records], np.float64) * dur
    completed = np.array([r.completed for r in records], bool)
    oom = np.array([r.outcome in ("oom", "oom-fail") for r in records], bool)
    tenants, t_code = _factorize([r.tenant for r in records])
    n_t = len(tenants)
    per_tenant = {
        t: {"allocated_gb_s": float(a), "used_gb_s": float(u),
            "wastage_gb_s": float(a - u)}
        for t, a, u in zip(tenants,
                           np.bincount(t_code, weights=alloc, minlength=n_t),
                           np.bincount(t_code, weights=used, minlength=n_t))}
    return WastageReport(
        n_records=len(records),
        n_completed=int(completed.sum()),
        allocated_gb_s=float(alloc.sum()),
        used_gb_s=float(used.sum()),
        wastage_gb_s=float(alloc.sum() - used.sum()),
        oom_kills=int(oom.sum()),
        oom_failures=sum(1 for r in records if r.outcome == "oom-fail"),
        retry_overhead_s=float(dur[oom].sum()),
        per_tenant=per_tenant,
    )
