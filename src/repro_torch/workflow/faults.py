"""Deterministic fault injection + recovery policies (beyond-paper).

Tarema's evaluation assumes a stable cluster, but the heterogeneous
commodity clusters it targets lose and regain nodes, run straggling or hung
tasks, and restart mid-workflow.  This module supplies the fault model and
the recovery-policy knobs behind ``EngineConfig.faults`` (default **off**,
in which case the engine is bit-for-bit seed-equivalent — the fault paths
draw from their own crc32-derived streams and never touch the engine RNG):

  * **Node churn** — every node carries an exponential crash clock
    (``crash_mttf_s``) and an exponential downtime (``mean_downtime_s``);
    a crashed node's running tasks are killed (logged
    ``outcome="node-crash"``) and the node *rejoins* later, re-entering
    every scheduler's feasibility masks and Tarema's group index arrays
    via the engine's incremental mask/rate repair (no rebuilds).
    ``min_live_nodes`` keeps the model from sinking the whole cluster.
  * **Degraded nodes** — an exponential clock (``degrade_mtbf_s``) slows a
    node by a factor drawn from ``degrade_factor`` for an exponential
    duration, then restores it: the straggler regime the speculation
    machinery exists for, now generated instead of hand-injected.
  * **Transient task failures** — each attempt independently fails with
    ``task_fail_prob`` at a deterministic fraction of its work
    (``fail_progress``), logged ``outcome="task-failure"``.
  * **Hung tasks** — each attempt hangs with ``hang_prob`` (its work is
    inflated by ``hang_factor``); the *timeout* policy reaps any attempt
    that exceeds ``max(timeout_floor_s, timeout_factor * p95)`` wall-clock
    (``outcome="timeout"``) — a hard cap on top of speculation, which only
    races stragglers but never kills them.

  * **Retry policy** — every fault-induced kill (crash victim, transient
    failure, timeout) consumes one unit of the task's retry budget
    (``max_task_retries``) and re-enters the queue only after an
    exponential-backoff delay (``backoff_base_s * backoff_factor**k``,
    capped at ``backoff_cap_s``).  A task that exhausts its budget fails
    permanently (``outcome="fault-fail"``) and its downstream subtree is
    cancelled (``outcome="cancelled"``), exactly like OOM exhaustion.

Every stochastic draw is keyed on ``zlib.crc32`` of the node/instance name
plus ``FaultConfig.seed`` (see ``repro_torch.core.seeding``), so a fault schedule
reproduces across processes and across the engine's snapshot/restore
boundary: per-node churn streams advance only when their node's events are
processed, and per-attempt draws are pure functions of
``(instance, fault_retries)``.

``fault_report`` reduces an assignment log into the recovery numbers the
chaos bench (``benchmarks/faults_bench.py``) is judged by.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.seeding import stable_seed

# fault-attempt outcome names appended to Engine.assignment_log
FAULT_KILL_OUTCOMES = ("node-crash", "task-failure", "timeout")
PERMANENT_FAILURE_OUTCOMES = ("oom-fail", "fault-fail")

# salts for the independent crc32-derived streams (arbitrary, fixed)
_SALT_CRASH = 0xC4A5
_SALT_DEGRADE = 0xDE64
_SALT_ATTEMPT = 0x7F417


# ---------------------------------------------------- shared policy helpers
# Pure functions of (history, budgets) used identically by the simulator's
# FaultModel and the real-execution control plane's liveness loop
# (repro_torch.workflow.controlplane) — one definition so the two paths can never
# drift on what "timed out" or "backed off" means.

def attempt_timeout(db, workflow: str, task_name: str,
                    factor: Optional[float], floor_s: float) -> float:
    """Wall-clock cap for one attempt: ``factor * p95`` of historic
    runtimes (floored at ``floor_s``), +inf until history exists — a task
    that was never observed cannot be distinguished from a long first run.
    A genuine 0.0 p95 (instant tasks) still caps at the floor instead of
    disabling the reaper."""
    if factor is None:
        return math.inf
    p95 = db.runtime_quantile(workflow, task_name, 0.95, method="linear")
    if p95 is None:
        return math.inf
    return max(floor_s, factor * p95)


def backoff_delay(retries: int, base_s: float, factor: float,
                  cap_s: float) -> float:
    """Delay before retry number ``retries`` (1-based) re-queues:
    ``base * factor**(retries-1)`` capped at ``cap_s``."""
    return min(cap_s, base_s * factor ** (retries - 1))


@dataclasses.dataclass
class FaultConfig:
    """Engine-facing fault-injection knobs (``EngineConfig.faults``).

    All intensity knobs default to *off* (no churn, no task faults, no
    hangs) so a ``FaultConfig()`` enables only the retry/timeout policy
    plumbing; the chaos bench and tests opt into each fault class
    explicitly.  ``seed`` shifts every stream at once.
    """
    seed: int = 0
    # -- node churn -------------------------------------------------------
    crash_mttf_s: Optional[float] = None   # per-node mean time to crash
    mean_downtime_s: float = 90.0          # mean crash->rejoin gap
    min_live_nodes: int = 1                # churn never drops below this
    # -- degraded nodes ---------------------------------------------------
    degrade_mtbf_s: Optional[float] = None  # per-node mean time to degrade
    degrade_factor: tuple = (0.3, 0.7)      # slow-factor multiplier range
    mean_degrade_s: float = 120.0           # mean degraded duration
    # -- transient task failures -----------------------------------------
    task_fail_prob: float = 0.0            # per-attempt failure probability
    fail_progress: tuple = (0.05, 0.95)    # work fraction at failure point
    # -- hung tasks + timeout reaping ------------------------------------
    hang_prob: float = 0.0                 # per-attempt hang probability
    hang_factor: float = 20.0              # work inflation of a hung attempt
    timeout_factor: Optional[float] = 8.0  # wall cap = factor * historic p95
    timeout_floor_s: float = 30.0          # never reap faster than this
    # -- retry policy -----------------------------------------------------
    max_task_retries: int = 3              # fault-kill budget per instance
    backoff_base_s: float = 5.0            # first retry delay
    backoff_factor: float = 2.0            # exponential backoff multiplier
    backoff_cap_s: float = 300.0           # delay ceiling

    def __post_init__(self):
        for name in ("crash_mttf_s", "degrade_mtbf_s", "timeout_factor"):
            v = getattr(self, name)
            if v is not None and not v > 0.0:
                raise ValueError(f"{name} must be > 0 (or None to disable)")
        for name in ("mean_downtime_s", "mean_degrade_s", "hang_factor",
                     "backoff_factor"):
            if not getattr(self, name) > 0.0:
                raise ValueError(f"{name} must be > 0")
        for name in ("task_fail_prob", "hang_prob"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]")
        for name, (lo, hi) in (("fail_progress", self.fail_progress),
                               ("degrade_factor", self.degrade_factor)):
            if not (0.0 < lo <= hi <= 1.0):
                raise ValueError(f"{name} must satisfy 0 < lo <= hi <= 1")
        if self.min_live_nodes < 0 or self.max_task_retries < 0:
            raise ValueError("min_live_nodes/max_task_retries must be >= 0")
        if self.backoff_base_s < 0.0 or self.backoff_cap_s < 0.0:
            raise ValueError("backoff delays must be >= 0")


class FaultModel:
    """Runtime state of the fault model for one engine.

    Per-node churn/degrade streams are *stateful* generators (advanced only
    when that node's events are processed — interleavings of other nodes
    never shift them) and are part of the engine snapshot; per-attempt
    draws are stateless pure functions of ``(instance, attempt)``.  Both
    are crc32-seeded, so fault schedules reproduce across processes.
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._churn_rng: dict = {}      # node -> Generator (crash/downtime)
        self._degrade_rng: dict = {}    # node -> Generator (degrade clock)

    def _stream(self, cache: dict, node: str, salt: int):
        g = cache.get(node)
        if g is None:
            g = cache[node] = np.random.default_rng(
                (stable_seed(node), self.cfg.seed, salt))
        return g

    # -- node churn -------------------------------------------------------
    def next_crash(self, node: str, after: float) -> Optional[float]:
        """Next crash time for ``node``, or None when churn is disabled."""
        if self.cfg.crash_mttf_s is None:
            return None
        return after + float(self._stream(self._churn_rng, node, _SALT_CRASH)
                             .exponential(self.cfg.crash_mttf_s))

    def downtime(self, node: str) -> float:
        return float(self._stream(self._churn_rng, node, _SALT_CRASH)
                     .exponential(self.cfg.mean_downtime_s))

    # -- degraded nodes ---------------------------------------------------
    def next_degrade(self, node: str, after: float) -> Optional[float]:
        if self.cfg.degrade_mtbf_s is None:
            return None
        return after + float(self._stream(self._degrade_rng, node,
                                          _SALT_DEGRADE)
                             .exponential(self.cfg.degrade_mtbf_s))

    def degrade_params(self, node: str) -> tuple:
        """(slow-factor multiplier, degraded duration) for one episode."""
        g = self._stream(self._degrade_rng, node, _SALT_DEGRADE)
        lo, hi = self.cfg.degrade_factor
        factor = lo + (hi - lo) * float(g.random())
        duration = float(g.exponential(self.cfg.mean_degrade_s))
        return factor, duration

    # -- per-attempt faults ----------------------------------------------
    def attempt_faults(self, instance: str, attempt: int) -> tuple:
        """(failure work-fraction | None, hung flag) for one attempt.

        Pure in ``(instance, attempt, cfg.seed)`` — no stream state, so
        retries re-draw independently and snapshot/restore replays exactly.
        A transiently-failing attempt never also hangs (the failure point
        arrives first).
        """
        cfg = self.cfg
        if cfg.task_fail_prob <= 0.0 and cfg.hang_prob <= 0.0:
            return None, False
        r = np.random.default_rng(
            (stable_seed(instance), cfg.seed, attempt, _SALT_ATTEMPT)).random(3)
        if cfg.task_fail_prob > 0.0 and r[0] < cfg.task_fail_prob:
            lo, hi = cfg.fail_progress
            return lo + (hi - lo) * float(r[1]), False
        if cfg.hang_prob > 0.0 and r[2] < cfg.hang_prob:
            return None, True
        return None, False

    # -- policies ---------------------------------------------------------
    @property
    def has_timeouts(self) -> bool:
        return self.cfg.timeout_factor is not None

    def timeout_for(self, db, task) -> float:
        """Wall-clock cap for one attempt (see ``attempt_timeout``)."""
        return attempt_timeout(db, task.workflow, task.name,
                               self.cfg.timeout_factor,
                               self.cfg.timeout_floor_s)

    def backoff_delay(self, retries: int) -> float:
        """Delay before retry number ``retries`` (1-based) re-queues."""
        return backoff_delay(retries, self.cfg.backoff_base_s,
                             self.cfg.backoff_factor, self.cfg.backoff_cap_s)


# ---------------------------------------------------------------- report
@dataclasses.dataclass
class FaultReport:
    """Recovery outcome of one engine run's assignment log.

    ``lost_core_s`` integrates the core-seconds consumed by fault-killed
    attempts (crash victims, transient failures, timeouts) — the service
    the cluster paid without progress; ``recovery_overhead_s`` is the same
    integral over wall time.  Permanent failures and their cancelled
    descendants count completed work lost *forever*, not just retried.
    """
    n_records: int
    n_completed: int
    by_outcome: dict                 # outcome -> record count
    lost_core_s: float               # core-s of fault-killed attempts
    recovery_overhead_s: float       # wall-s of fault-killed attempts
    fault_failures: int              # instances that exhausted the budget
    cancelled: int                   # descendants cancelled by those

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def fault_report(records) -> FaultReport:
    """Vectorized reduction of an assignment log (``fairness.py`` idiom)."""
    if not records:
        return FaultReport(0, 0, {}, 0.0, 0.0, 0, 0)
    by_outcome: dict = {}
    for r in records:
        by_outcome[r.outcome] = by_outcome.get(r.outcome, 0) + 1
    dur = (np.array([r.end for r in records], np.float64)
           - np.array([r.start for r in records], np.float64))
    cores = np.array([r.cores for r in records], np.float64)
    killed = np.array([r.outcome in FAULT_KILL_OUTCOMES for r in records],
                      bool)
    return FaultReport(
        n_records=len(records),
        n_completed=sum(1 for r in records if r.completed),
        by_outcome=by_outcome,
        lost_core_s=float((dur * cores)[killed].sum()),
        recovery_overhead_s=float(dur[killed].sum()),
        fault_failures=by_outcome.get("fault-fail", 0),
        cancelled=by_outcome.get("cancelled", 0),
    )
