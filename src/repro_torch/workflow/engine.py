"""Discrete-event heterogeneous-cluster engine (the Kubernetes/Nextflow
stand-in the paper's evaluation runs on), vectorized for fleet scale.

Execution model (unchanged from the seed engine, see ``engine_ref.py``): a
running task owns its reserved cores outright, progresses through blended
cpu/mem/io work at node-dependent rates, and *shares* memory bandwidth with
co-resident tasks and volume I/O bandwidth cluster-wide.  This contention is
exactly the mechanism §V-E-b cites for Tarema beating SJFN.

What changed for 10^3-node / 10^5-instance fleets (the seed implementation
is preserved verbatim in ``engine_ref.py`` and the equivalence tests assert
bit-for-bit identical makespans and assignment traces):

  * ready promotion is dependency-counter based: a ``deps_left`` map is
    decremented as predecessors finish — O(total edges) per run instead of
    an O(all tasks) rescan per event;
  * rate / time-left / advance math runs over structure-of-arrays state:
    per-node contention inputs (free cores, co-resident count, straggler
    factor) and per-running-task remaining work live in numpy arrays that
    are maintained incrementally on start/finish/kill, so each event costs
    a handful of vectorized ops instead of a Python loop re-deriving every
    rate twice;
  * the next-finish search is a masked argmin over kept-dense task slots;
    slot order equals ``running``-dict insertion order, so tie-breaking is
    identical to the seed's ``min`` over dict items;
  * placement runs through the *array-native scheduler protocol*: one
    numpy feasibility mask per distinct (cores, mem) demand, kept across
    passes and repaired by index pokes as events dirty single nodes, with
    schedulers choosing via ``select_node_idx(task, mask, db)`` (masked
    argmin/argsort over arrays bound once per run) and a blocked-queue
    early exit that stops a pass once no enabled node can host the min
    demand remaining — a saturated deep queue costs O(placements), not
    O(queue x nodes), per event.  External schedulers without the fast
    path are feature-detected and served by the legacy per-task dict pass
    (``EngineConfig.placement_path``); both paths are pinned bit-for-bit
    interchangeable by ``tests/test_scheduler_protocol.py``;
  * the speculation machinery (straggler scan + p95 wake-ups) runs off
    per-slot cached quantile state maintained on history writes instead of
    per-event Python loops over ``running``.

Floating-point evaluation order inside the rate formulas is kept exactly as
in the seed so results match bit-for-bit, not just statistically.

Fault-tolerance features (beyond-paper, used by the FT tests/examples):
  * node failure injection — running tasks are re-queued, node leaves;
  * straggler injection + speculative re-execution (first copy to finish
    wins), gated on the monitor's historic p95.  A losing pair half that is
    still queued runs redundantly under the seed-pinned default; set
    ``EngineConfig.cancel_stale_speculative`` to drop it instead (found by
    the property-based invariant suite);
  * online memory sizing + OOM-retry semantics (``EngineConfig.sizing``,
    see ``repro_torch.core.sizing``): queued tasks run under a *predicted*
    ``req_mem_gb``; an attempt whose sampled peak exceeds the sized request
    raises an OOM failure partway through its work and is retried under an
    escalated request (every attempt logged to ``assignment_log``), failing
    permanently — downstream subtree cancelled — once ``max_retries`` is
    exhausted.  Default off, bit-for-bit seed-equivalent.

Every task attempt — completed or killed (node failure, OOM, speculative
loser) — is appended to ``assignment_log``; killed attempts carry
``completed=False`` so fairness/wastage accounting sees the service that
failures consumed (the seed logged only completions).  Descendants
cancelled by a permanent failure are logged too (``outcome="cancelled"``,
zero-duration, no node).

Robustness subsystem (beyond-paper, default off — see
``repro_torch.workflow.faults`` and ROADMAP "Robustness methodology"):
  * ``EngineConfig.faults`` enables deterministic node churn
    (crash/rejoin), degraded-node episodes, transient task failures,
    hung-task inflation + timeout reaping, and per-task retry budgets with
    exponential backoff.  Rejoining nodes re-enter placement incrementally
    (feasibility-mask poke + rate_stale flag — no rebuilds);
  * exogenous events (user failures, churn, backoff requeues) live in one
    persistent heap processed at exact event boundaries, preserving the
    seed's (time, node) failure ordering bit-for-bit;
  * ``run(until=t)`` pauses at the first event boundary >= t and
    ``snapshot()``/``restore()`` serialize the complete engine — node SoA,
    queues, running slots, RNG/fault streams, TraceDB epoch — so a run
    crash-recovers or warm-starts in another process with zero equivalence
    drift (``tests/test_faults.py`` pins resumed == uninterrupted).

Known-broken seed paths fixed here (unreachable by the equivalence suite):
the idle-with-pending-failure branch indexed the failure *node* instead of
its time (a guaranteed TypeError) and then looped without disabling the
node; this engine jumps to the next exogenous event (failure or delayed
submission) and processes it.
"""
from __future__ import annotations

import dataclasses
import heapq
import pickle
import time
from collections import defaultdict
from typing import Optional

import numpy as np

from repro_torch.core.fairness import AssignmentRecord
from repro_torch.core.monitor import TaskTrace, TraceDB
from repro_torch.core.prediction import (PredictionConfig, PredictionRecord,
                                   make_predictor)
from repro_torch.core.profiler import NodeSpec
from repro_torch.core.sizing import SizingConfig, make_sizer
from repro_torch.workflow.controlplane import detect_array_path, suffix_min_demand
from repro_torch.workflow.dag import (TaskInstance, WorkflowSpec, instantiate,
                                stable_seed)
from repro_torch.workflow.faults import FaultConfig, FaultModel

# Contention defaults: calibrated against the paper's Fig. 4/5 gaps
# (see EXPERIMENTS.md §Calibration); overridable per EngineConfig.
MEM_SHARE_BETA = 0.62        # memory-bandwidth contention strength
MEM_SHARE_CAP = 8.0
IO_SHARE_GAMMA = 0.08        # shared-volume contention strength
SMT_PENALTY = 0.15           # CPU slowdown at full occupancy (vCPUs are SMT
                             # threads; single-threaded benchmarks miss this)
BW_EXP = 0.30                 # node bandwidth ~ (cores/8)**BW_EXP

_REM_FEATURES = ("cpu", "mem", "io")   # column order of the remaining-work SoA

# exogenous-event kinds; the value doubles as the heap priority, so
# same-time events apply in this fixed order and — because the key type is
# homogeneous per kind — heap tuples always compare cleanly.  Priority 0
# for failures keeps the seed's (time, node) failure processing order.
_EXO_FAIL, _EXO_REJOIN, _EXO_DEGRADE, _EXO_RESTORE, _EXO_REQUEUE = range(5)

_FAULT_STAT_KEY = {"node-crash": "crash_kills", "task-failure": "task_failures",
                   "timeout": "timeouts"}

_SNAPSHOT_VERSION = 1


class _NodeArrays:
    """Structure-of-arrays over the cluster's nodes.

    Static columns are derived from the specs once (preserving the seed's
    exact multiplication order, e.g. ``mem_static = mem_bw * 0.02``);
    dynamic columns (free cores/mem, co-resident count, straggler factor,
    disabled flag) are the single source of truth and are exposed through
    ``SimNode`` properties for scheduler/test compatibility.
    """

    __slots__ = ("names", "index", "cores", "mem_gb", "cpu_speed",
                 "app_factor", "io_seq", "mem_static", "bw_scale",
                 "free_cores", "free_mem", "n_running", "slow", "disabled",
                 "rate_cpu", "rate_mem", "rate_stale", "mask_dirty")

    def __init__(self, specs: list[NodeSpec], bw_exp: float):
        self.names = [s.name for s in specs]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.cores = np.array([s.cores for s in specs], np.int64)
        self.mem_gb = np.array([s.mem_gb for s in specs], np.float64)
        self.cpu_speed = np.array([s.cpu_speed for s in specs], np.float64)
        self.app_factor = np.array([s.app_factor for s in specs], np.float64)
        self.io_seq = np.array([s.io_seq for s in specs], np.float64)
        # total memory bandwidth scales sublinearly with the VM's core count
        # (bigger GCP shapes span more memory channels); benchmarks are
        # single-threaded so Table IV numbers are unaffected
        self.mem_static = np.array([s.mem_bw for s in specs], np.float64) * 0.02
        self.bw_scale = (self.cores / 8.0) ** bw_exp
        self.free_cores = self.cores.copy()
        self.free_mem = self.mem_gb.copy()
        self.n_running = np.zeros(len(specs), np.int64)
        self.slow = np.ones(len(specs), np.float64)
        self.disabled = np.zeros(len(specs), bool)
        # cached per-node cpu/mem service rates: both are pure elementwise
        # functions of node-local state (occupancy, co-resident count, slow
        # factor), so only nodes whose state changed since the last event
        # need recomputing — `rate_stale` marks them (all at first use)
        self.rate_cpu = np.zeros(len(specs), np.float64)
        self.rate_mem = np.zeros(len(specs), np.float64)
        self.rate_stale = np.ones(len(specs), bool)
        # nodes whose free cores/mem/disabled state changed since the last
        # placement pass repaired its cached feasibility masks (engine-
        # drained; SimNode property writes append here too so external
        # mutations — test injection, failure handling — are never missed)
        self.mask_dirty: list = []

    def feasible_mask(self, req_cores, req_mem_gb) -> np.ndarray:
        """Vector form of THE feasibility predicate (single source, with
        ``feasible_at`` as its scalar twin for incremental mask repair)."""
        return ((~self.disabled) & (self.free_cores >= req_cores)
                & (self.free_mem >= req_mem_gb))

    def feasible_at(self, i: int, req_cores, req_mem_gb) -> bool:
        return bool((not self.disabled[i]) and self.free_cores[i] >= req_cores
                    and self.free_mem[i] >= req_mem_gb)


class SimNode:
    """Per-node view consumed by schedulers and tests.

    Dynamic fields are array-backed properties so external writes (e.g. the
    straggler tests setting ``slow_factor``) are visible to the vectorized
    rate computation without any per-event refresh.
    """

    __slots__ = ("spec", "running", "_na", "_i")

    def __init__(self, spec: NodeSpec, na: _NodeArrays, i: int):
        self.spec = spec
        self.running: set = set()
        self._na = na
        self._i = i

    @property
    def name(self):
        return self.spec.name

    @property
    def free_cores(self) -> int:
        return int(self._na.free_cores[self._i])

    @property
    def free_mem(self) -> float:
        return float(self._na.free_mem[self._i])

    @property
    def slow_factor(self) -> float:
        return float(self._na.slow[self._i])

    @slow_factor.setter
    def slow_factor(self, v: float):
        self._na.slow[self._i] = v
        self._na.rate_stale[self._i] = True   # cpu rate depends on slow

    @property
    def disabled(self) -> bool:
        return bool(self._na.disabled[self._i])

    @disabled.setter
    def disabled(self, v: bool):
        self._na.disabled[self._i] = v
        self._na.mask_dirty.append(self._i)

    def load(self) -> float:
        cores = 1.0 - self.free_cores / self.spec.cores
        mem = 1.0 - self.free_mem / self.spec.mem_gb
        return 0.5 * (cores + mem)


@dataclasses.dataclass
class EngineConfig:
    # Which execution backend this run is meant for.  The Engine class IS
    # the simulated backend ("sim", the default and the only value it
    # accepts); real execution goes through the control-plane split —
    # ``repro_torch.workflow.controlplane.ControlPlane`` + ``make_backend`` (e.g.
    # "local" -> ``jobmanager.LocalProcessBackend``).  The field exists so
    # configs are self-describing about which layer they drive and so a
    # config written for a real backend fails loudly here instead of
    # silently simulating.
    backend: str = "sim"
    speculation: bool = False
    speculation_factor: float = 1.8   # relaunch if runtime > factor * p95
    # Cancel the losing half of a speculative pair while it is still
    # *queued* (copy not yet placed, or primary requeued by a node failure
    # after its copy won).  The seed leaves such losers in the queue to run
    # redundantly — the invariant suite flags that as a duplicated
    # completion — but its semantics are pinned bit-for-bit by the
    # equivalence tests, so the fix is opt-in (default: seed behaviour).
    cancel_stale_speculative: bool = False
    # Order statistic behind the speculation p95: "seed" pins the seed's
    # max-biased int(q*n) index for bit-for-bit equivalence; "linear" is
    # the corrected interpolated quantile (see TraceDB._quantile) — on
    # histories of <= 20 samples the seed method returns the maximum, so
    # early-history speculation over-fires against the worst run ever seen.
    quantile_method: str = "seed"
    # Online memory sizing + OOM-retry semantics (repro_torch.core.sizing).
    # None (default) reserves every instance's static spec request and
    # never raises OOM events — bit-for-bit seed-equivalent.
    sizing: Optional[SizingConfig] = None
    # Placement path: "auto" uses the array-native scheduler protocol
    # (select_node_idx over a numpy feasibility mask, incremental per-pass
    # mask maintenance, blocked-queue early exit) whenever the scheduler
    # opts in, falling back to the per-task dict interface otherwise
    # (external schedulers, or subclasses that customized select_node
    # without an array twin).  "dict" forces the legacy path; "array"
    # requires the fast path and raises if the scheduler can't serve it.
    # Both paths are bit-for-bit identical (tests/test_scheduler_protocol).
    placement_path: str = "auto"
    # Online runtime/interference prediction (repro_torch.core.prediction): the
    # engine records a completion-time prediction for every placement
    # (so prediction error is measurable for any scheduler) and feeds
    # completed attempts back into the model — which is what makes
    # PredictiveScheduler learn.  None (default) disables the whole
    # subsystem — bit-for-bit seed-equivalent — and the engine refuses a
    # model-carrying scheduler rather than letting it run cold forever.
    prediction: Optional[PredictionConfig] = None
    # Fault injection + recovery policies (repro_torch.workflow.faults): node
    # churn (crash/rejoin), degraded-node episodes, transient task
    # failures, hung-task timeouts, and retry budgets with exponential
    # backoff.  None (default) disables the whole subsystem — bit-for-bit
    # seed-equivalent.  Decided at engine construction.
    faults: Optional[FaultConfig] = None
    seed: int = 0
    usage_noise: float = 0.03
    mem_beta: float = MEM_SHARE_BETA
    mem_cap: float = MEM_SHARE_CAP
    io_gamma: float = IO_SHARE_GAMMA
    smt_penalty: float = SMT_PENALTY
    bw_exp: float = BW_EXP


class Engine:
    def __init__(self, specs: list[NodeSpec], scheduler, db: TraceDB,
                 config: Optional[EngineConfig] = None,
                 disabled_nodes: Optional[set] = None):
        # one config per engine: the seed's `config=EngineConfig()` default
        # was a shared mutable instance across every default-configured run
        self.cfg = EngineConfig() if config is None else config
        if self.cfg.backend != "sim":
            raise ValueError(
                f"EngineConfig.backend={self.cfg.backend!r}: the Engine is "
                "the simulated backend; real backends are not ported yet "
                "(repro_torch.workflow.controlplane holds only the shared "
                "placement helpers)")
        self._na = _NodeArrays(specs, self.cfg.bw_exp)
        self.nodes = {s.name: SimNode(s, self._na, i)
                      for i, s in enumerate(specs)}
        for n in disabled_nodes or ():
            self.nodes[n].disabled = True
        self.scheduler = scheduler
        self.db = db
        self.rng = np.random.default_rng(self.cfg.seed)
        self.t = 0.0
        self.queue: list[TaskInstance] = []
        self.running: dict[str, TaskInstance] = {}
        self.done: dict[str, TaskInstance] = {}
        self.all_tasks: dict[str, TaskInstance] = {}
        self.assignments: list[tuple] = []       # (task_name, node, start, end)
        # richer per-finish records (tenant, run identity, reservation) for
        # fairness accounting; the seed-shaped `assignments` tuples stay
        # untouched so the bit-for-bit equivalence suite keeps comparing them
        self.assignment_log: list[AssignmentRecord] = []
        self._failures: list[tuple] = []         # (time, node)
        self._spec_copies: dict[str, str] = {}   # primary id -> copy id
        self._uid = 0      # plain int counters (itertools.count in the seed
        # shape) so the whole engine pickles for snapshot()/restore()
        # online memory sizing (None == seed semantics, no OOM events)
        self._sizer = None if self.cfg.sizing is None \
            else make_sizer(self.cfg.sizing)
        self._refresh_mem_cap()
        self.sizing_stats = {"oom_events": 0, "oom_failures": 0,
                             "retry_overhead_s": 0.0}
        # online runtime prediction (None == seed semantics, no recording).
        # The predictor is armed lazily in _prepare: a PredictiveScheduler
        # carries its own (possibly pre-warmed) model, and the node-group
        # map comes from the scheduler's profiling when it has one.
        self._predictor = None
        self._pred_group: dict = {}              # node name -> group id
        self._pred_pending: dict = {}            # instance -> placement pred
        self.prediction_log: list[PredictionRecord] = []
        # fault injection + recovery policies (None == seed semantics)
        self._faults = None if self.cfg.faults is None \
            else FaultModel(self.cfg.faults)
        self._faults_armed = False
        self.fault_stats = {"crashes": 0, "rejoins": 0, "degrades": 0,
                            "crash_kills": 0, "task_failures": 0,
                            "timeouts": 0, "retries": 0, "fault_failures": 0,
                            "backoff_wait_s": 0.0}
        # persistent exogenous-event heap: (time, kind, key, payload) for
        # user failures, churn crash/rejoin, degrade/restore, and backoff
        # requeues.  fail_node_at registrations are ingested at _prepare
        # (cursor below), so resumed runs never re-ingest.
        self._exo: list = []
        self._failures_ingested = 0
        self._user_failed: set = set()           # permanently failed by user
        self._backoff_until: dict = {}           # instance -> requeue time
        # append-only running-task slots (SoA); slot order == start order ==
        # `running`-dict insertion order, which the argmin tie-break relies on
        self._slot_cap = 256
        self._rem = np.zeros((self._slot_cap, 3), np.float64)
        self._slot_node = np.zeros(self._slot_cap, np.int64)
        self._slot_io = np.ones(self._slot_cap, np.float64)   # io_seq[node]
        self._slot_active = np.zeros(self._slot_cap, bool)
        # wall-clock kill deadline per slot (+inf without a faults timeout
        # policy or historic p95) — scanned with the next-finish argmin
        self._slot_deadline = np.full(self._slot_cap, np.inf)
        self._slot_tasks: list[Optional[TaskInstance]] = [None] * self._slot_cap
        self._n_slots = 0
        self._n_active = 0
        self._task_slot: dict[str, int] = {}
        # speculation SoA: per-slot start time + current p95 (0.0 encodes
        # "ineligible or no history", matching the seed's falsy-p95 guard).
        # Maintained incrementally — on start, on history writes for the
        # same (workflow, task), and on speculative-pair transitions — so
        # the per-event straggler scan is a vectorized comparison instead
        # of a Python loop re-reading quantiles for every running task.
        # (_spec_on is re-read from the live config at every _prepare, so
        # flipping cfg.speculation between construction and run() works.)
        self._spec_on = self.cfg.speculation
        self._slot_start = np.zeros(self._slot_cap, np.float64)
        self._spec_p95 = np.zeros(self._slot_cap, np.float64)
        self._name_slots: dict[tuple, set] = defaultdict(set)
        # array-native placement state (decided per run in _prepare)
        self._use_array = False
        self._mask_cache: dict[tuple, np.ndarray] = {}
        # per-phase wall-clock accounting (see engine_bench breakdown)
        self._sched_wall = 0.0
        self._monitor_wall = 0.0
        self.phase_wall: dict = {}
        # dependency-counter scheduling state (built in _prepare at run())
        self._seq: dict[str, int] = {}           # instance -> submission order
        self._seq_next = 0
        self._deps_left: dict[str, int] = {}
        self._dependents: dict[str, list] = {}
        self._ready_batch: list[str] = []        # deps satisfied, not promoted
        self._arrivals: list[tuple] = []         # (submit_t, seq, instance)
        self._unfinished = 0
        self._max_end = 0.0

    # ------------------------------------------------------------ submission
    def submit(self, spec: WorkflowSpec, run_id: int, seed: int = 0,
               at: float = 0.0, input_scale: float = 1.0,
               tenant: str = "default", prefix: Optional[str] = None):
        """Instantiate `spec` into the engine at time `at`.

        ``tenant`` tags every instance (carried into the assignment log and
        TaskTrace records for fairness accounting).  ``prefix`` namespaces
        instance ids (``"{prefix}/align[3]"``): without it, same-named tasks
        of different submissions *overwrite* each other (the seed semantics
        the equivalence suite pins); streams of repeated or same-workflow
        runs need the namespace to coexist in one engine.
        """
        for inst in instantiate(spec, run_id, seed, input_scale):
            inst.submit_t = at
            inst.tenant = tenant
            if prefix is not None:
                inst.instance = f"{prefix}/{inst.instance}"
                inst.deps = tuple(f"{prefix}/{d}" for d in inst.deps)
            if inst.instance not in self._seq:
                self._seq[inst.instance] = self._seq_next
                self._seq_next += 1
            self.all_tasks[inst.instance] = inst

    def fail_node_at(self, t: float, node: str):
        """Register a *permanent* node failure at time ``t``.

        Validated here, at registration — an unknown node or a duplicate
        failure of an already-failed node raises immediately instead of
        failing deep in the event loop mid-run.  A user-failed node never
        rejoins, even under a churn fault model."""
        if node not in self.nodes:
            raise ValueError(f"fail_node_at: unknown node {node!r}")
        if node in self._user_failed:
            raise ValueError(f"fail_node_at: node {node!r} already has a "
                             "registered failure")
        self._user_failed.add(node)
        self._failures.append((t, node))

    # ----------------------------------------------------- vectorized rates
    def _node_rates(self):
        """Per-node (cpu, mem) service rates + the cluster-wide I/O-share
        denominator, refreshed incrementally.

        Expression structure mirrors the seed's `_rates` exactly (same
        operand order) so gathered per-task rates are bit-identical; cpu
        and mem are elementwise in node-local state, so only nodes flagged
        ``rate_stale`` (their reservations or slow factor changed since the
        last event) are recomputed.  The I/O denominator depends on the
        global running count, so it is returned as a scalar and applied
        after the per-task gather — ``io_seq[nd] / denom`` is the same
        float op as gathering a pre-divided array.
        """
        na, cfg = self._na, self.cfg
        if na.rate_stale.any():
            d = np.flatnonzero(na.rate_stale)
            # SMT/LLC contention: past 50% vCPU occupancy, co-runners share
            # physical cores and last-level cache
            occ = 1.0 - na.free_cores[d] / na.cores[d]
            smt = 1.0 - cfg.smt_penalty * np.maximum(0.0, occ - 0.5) / 0.5
            slow = na.slow[d] * na.app_factor[d]
            na.rate_cpu[d] = na.cpu_speed[d] * slow * smt
            na.rate_mem[d] = na.mem_static[d] * slow * na.bw_scale[d] \
                / np.minimum(1.0 + cfg.mem_beta
                             * np.maximum(0, na.n_running[d] - 1), cfg.mem_cap)
            na.rate_stale[d] = False
        io_denom = 1.0 + cfg.io_gamma * max(0, len(self.running) - 1)
        return na.rate_cpu, na.rate_mem, io_denom

    def _time_left_full(self, n: int) -> np.ndarray:
        """Time-to-finish over slots [0:n] — the full (kept-dense) range,
        so every op is contiguous with no index gather of the remaining-work
        rows.  Dead slots yield garbage values the callers mask out; active
        slots are bit-identical to the seed's per-task math.  Callers run
        under run()'s blanket errstate (divide/invalid ignored)."""
        cpu, mem, io_denom = self._node_rates()
        nd = self._slot_node[:n]
        rem = self._rem[:n]
        return rem[:, 0] / cpu[nd] + rem[:, 1] / mem[nd] \
            + rem[:, 2] / (self._slot_io[:n] / io_denom)

    def _advance_full(self, dt, n: int, tl: np.ndarray):
        if dt <= 0 or n == 0:
            return
        # for dt > 0, min(dt/tl, 1) needs no tl==0 guard: dt/0 == +inf
        # saturates to 1, exactly the seed's where(tl > 0, ..., 1.0) branch
        frac = np.minimum(dt / tl, 1.0)
        self._rem[:n] *= (1.0 - frac)[:, None]

    # ------------------------------------------------------------- mechanics
    def _spec_excluded_idx(self, task: TaskInstance) -> int:
        """Node index a speculative pair pins away from `task`, or -1.

        A speculative copy must not land beside its (straggling) original —
        and symmetrically, a primary that re-enters the queue while its copy
        runs (requeued by a node failure) must not land on the copy's node:
        the seed only blocked the copy->original direction, so after a
        requeue both halves could share a node, defeating the point of
        speculation.  Only a *running* sibling pins a node (a finished
        copy's node stays set but no longer excludes: the seed-pinned
        redundant-loser path must still be placeable anywhere).
        """
        if task.speculative_of:
            orig = self.all_tasks.get(task.speculative_of)
            if orig is not None and orig.node:
                return self._na.index[orig.node]
        else:
            cid = self._spec_copies.get(task.instance)
            if cid is not None:
                copy = self.all_tasks.get(cid)
                if copy is not None and copy.state == "running" and copy.node:
                    return self._na.index[copy.node]
        return -1

    def _feasible(self, task: TaskInstance) -> dict:
        """Legacy dict-interface feasibility view (the array path uses the
        mask directly — see _place_array)."""
        na = self._na
        ok = na.feasible_mask(task.req_cores, task.req_mem_gb)
        feas = dict(zip(na.names, ok.tolist()))
        j = self._spec_excluded_idx(task)
        if j >= 0:
            feas[na.names[j]] = False
        return feas

    def _alloc_slot(self) -> int:
        if self._n_slots == self._slot_cap:
            self._slot_cap *= 2
            self._rem = np.resize(self._rem, (self._slot_cap, 3))
            self._slot_node = np.resize(self._slot_node, self._slot_cap)
            self._slot_io = np.resize(self._slot_io, self._slot_cap)
            self._slot_start = np.resize(self._slot_start, self._slot_cap)
            self._spec_p95 = np.resize(self._spec_p95, self._slot_cap)
            self._slot_deadline = np.resize(self._slot_deadline,
                                            self._slot_cap)
            grown = np.zeros(self._slot_cap, bool)
            grown[:self._n_slots] = self._slot_active[:self._n_slots]
            self._slot_active = grown
            self._slot_tasks.extend([None] * (self._slot_cap - len(self._slot_tasks)))
        s = self._n_slots
        self._n_slots += 1
        return s

    def _release_slot(self, instance: str):
        s = self._task_slot.pop(instance)
        if self._spec_on:
            t = self._slot_tasks[s]
            self._name_slots[(t.workflow, t.name)].discard(s)
        self._rem[s] = 0.0        # dead slots must stay NaN-free (0/rate=0)
        self._slot_active[s] = False
        self._slot_tasks[s] = None
        self._n_active -= 1

    def _maybe_compact(self):
        """Keep the slot range dense (compact once >1/3 is dead): the
        event math runs over [0:n_slots], so density — not just bounded
        garbage — is what the per-event cost rides on.  Stable order keeps
        the argmin tie-break identical to the running-dict iteration order;
        amortized cost is O(1) per finish."""
        if self._n_slots < 512 or self._n_active * 3 >= self._n_slots * 2:
            return
        live = np.flatnonzero(self._slot_active[:self._n_slots])
        n = live.size
        self._rem[:n] = self._rem[live]
        self._slot_node[:n] = self._slot_node[live]
        self._slot_io[:n] = self._slot_io[live]
        self._slot_start[:n] = self._slot_start[live]
        self._spec_p95[:n] = self._spec_p95[live]
        self._slot_deadline[:n] = self._slot_deadline[live]
        self._slot_active[:n] = True
        self._slot_active[n:self._n_slots] = False
        tasks = [self._slot_tasks[i] for i in live]
        self._slot_tasks[:n] = tasks
        for i in range(n, self._n_slots):
            self._slot_tasks[i] = None
        self._n_slots = n
        self._task_slot = {t.instance: i for i, t in enumerate(tasks)}
        if self._spec_on:
            ns: dict = defaultdict(set)
            for i, t in enumerate(tasks):
                ns[(t.workflow, t.name)].add(i)
            self._name_slots = ns

    def _start(self, task: TaskInstance, node_name: str):
        na = self._na
        i = na.index[node_name]
        na.free_cores[i] -= task.req_cores
        na.free_mem[i] -= task.req_mem_gb
        na.n_running[i] += 1
        na.rate_stale[i] = True
        na.mask_dirty.append(i)
        self.nodes[node_name].running.add(task.instance)
        task.state = "running"
        task.node = node_name
        task.start_t = self.t
        task.remaining = dict(task.work)   # informational; SoA is the truth
        # OOM dooming (sizing only): an attempt whose sampled peak exceeds
        # its sized request fails at a deterministic per-instance fraction
        # of its work — the slot simply carries the truncated remaining
        # work, so the vectorized next-finish machinery is untouched and
        # the "finish" event is reinterpreted as the OOM kill.
        frac = 1.0
        if self._sizer is not None and \
                task.req_mem_gb < task.peak_mem_gb - 1e-9:
            lo, hi = self.cfg.sizing.oom_progress
            u = np.random.default_rng(
                (stable_seed(task.instance), 0xA110C)).random()
            frac = lo + (hi - lo) * u
            task._oom_doomed = True
        else:
            task._oom_doomed = False
        # fault dooming (faults only): per-attempt transient-failure / hang
        # draws are pure functions of (instance, fault_retries) — retries
        # re-draw, and no engine RNG is consumed — plus the wall-clock kill
        # deadline.  An OOM-doomed attempt dies at its OOM point first.
        task._fault_doomed = False
        deadline = np.inf
        if self._faults is not None:
            if not task._oom_doomed:
                ffrac, hung = self._faults.attempt_faults(
                    task.instance, task.fault_retries)
                if ffrac is not None:
                    frac, task._fault_doomed = ffrac, True
                elif hung:
                    # a hung attempt inflates its work: the timeout reaps it
                    # (or speculation races it) instead of it finishing
                    frac = self.cfg.faults.hang_factor
            deadline = task.start_t + self._faults.timeout_for(self.db, task)
        s = self._alloc_slot()
        for j, f in enumerate(_REM_FEATURES):
            self._rem[s, j] = task.work[f] * frac
        self._slot_node[s] = i
        self._slot_io[s] = na.io_seq[i]
        self._slot_start[s] = task.start_t
        self._slot_deadline[s] = deadline
        self._slot_active[s] = True
        self._slot_tasks[s] = task
        self._task_slot[task.instance] = s
        self._n_active += 1
        if self._spec_on:
            self._spec_p95[s] = self._spec_p95_for(task)
            self._name_slots[(task.workflow, task.name)].add(s)
        if self._predictor is not None:
            # record the completion-time prediction made *at placement*:
            # co_res counts co-resident attempts including this one (the
            # occupancy the contention model charges), so the pending
            # tuple is exactly one training observation minus the actual
            g = self._pred_group.get(node_name, 0)
            co = int(na.n_running[i])
            p = self._predictor.predict(task.workflow, task.name, g)
            if p is None:
                self._pred_pending[task.instance] = (g, co, None, "none")
            else:
                self._pred_pending[task.instance] = (
                    g, co, p[0] * self._predictor.interference(co), p[1])
        self.running[task.instance] = task

    def _on_done(self, instance: str):
        """Decrement dependency counters of everything waiting on `instance`."""
        for d in self._dependents.get(instance, ()):
            self._deps_left[d] -= 1
            if self._deps_left[d] == 0:
                t = self.all_tasks[d]
                if t.state == "pending":
                    if t.submit_t <= self.t:
                        self._ready_batch.append(d)
                    else:
                        heapq.heappush(self._arrivals,
                                       (t.submit_t, self._seq[d], d))

    def _finish(self, task: TaskInstance, record: bool = True):
        na = self._na
        i = na.index[task.node]
        na.free_cores[i] += task.req_cores
        na.free_mem[i] += task.req_mem_gb
        na.n_running[i] -= 1
        na.rate_stale[i] = True
        na.mask_dirty.append(i)
        self.nodes[task.node].running.discard(task.instance)
        self.running.pop(task.instance, None)
        self._release_slot(task.instance)
        task.state = "done"
        task.end_t = self.t
        task.remaining = None
        self.done[task.instance] = task
        self.assignments.append((task.name, task.node, task.start_t, task.end_t))
        self.assignment_log.append(AssignmentRecord(
            task.instance, task.name, task.workflow, task.run_id, task.tenant,
            task.node, task.start_t, task.end_t, task.req_cores,
            task.req_mem_gb, task.submit_t, completed=True,
            used_mem_gb=task.peak_mem_gb, outcome="done"))
        if self._predictor is not None:
            pend = self._pred_pending.pop(task.instance, None)
            if pend is not None:
                g, co, pred_s, level = pend
                actual = task.end_t - task.start_t
                self.prediction_log.append(PredictionRecord(
                    task.instance, task.workflow, task.name, task.node, g,
                    pred_s, level, co, actual))
                # only completed attempts train the model; killed/partial
                # attempts are dropped in _kill
                self._predictor.observe(task.workflow, task.name, g, actual,
                                        co)
        self._unfinished -= 1
        if task.end_t > self._max_end:
            self._max_end = task.end_t
        if record and task.speculative_of is None:
            total = sum(task.work.values()) or 1.0
            # one batched draw == three sequential normal() calls (same
            # stream), in the seed's cpu/mem/io order; tolist() keeps the
            # stored usage values plain (JSON-serializable) floats
            noise = (1.0 + self.rng.normal(0, self.cfg.usage_noise, 3)).tolist()
            usage = {
                "cpu": 100.0 * task.req_cores * task.work["cpu"] / total * noise[0],
                "mem": task.peak_mem_gb * noise[1],
                "io": task.work["io"] * noise[2],
            }
            t0 = time.perf_counter()
            self.db.add(TaskTrace(task.workflow, task.name, task.instance,
                                  task.run_id, task.node,
                                  self.t - task.start_t, usage,
                                  tenant=task.tenant))
            self._monitor_wall += time.perf_counter() - t0
            if self._spec_on:
                # the new trace only moves this (workflow, task)'s p95:
                # refresh exactly the running slots that share the name
                self._respec_name(task.workflow, task.name)
        self._on_done(task.instance)

    def _kill(self, task: TaskInstance, requeue: bool,
              reason: Optional[str] = None):
        na = self._na
        i = na.index[task.node]
        na.free_cores[i] += task.req_cores
        na.free_mem[i] += task.req_mem_gb
        na.n_running[i] -= 1
        na.rate_stale[i] = True
        na.mask_dirty.append(i)
        self.nodes[task.node].running.discard(task.instance)
        self.running.pop(task.instance, None)
        self._release_slot(task.instance)
        self._pred_pending.pop(task.instance, None)
        # partial attempts consume cores/memory for their whole run: log
        # them (completed=False) so fairness/wastage accounting sees the
        # service — the seed silently dropped every killed attempt,
        # undercounting exactly the tenants that failures hit
        self.assignment_log.append(AssignmentRecord(
            task.instance, task.name, task.workflow, task.run_id, task.tenant,
            task.node, task.start_t, self.t, task.req_cores, task.req_mem_gb,
            task.submit_t, completed=False,
            used_mem_gb=min(task.peak_mem_gb, task.req_mem_gb),
            outcome=reason or ("node-failure" if requeue
                               else "speculative-loser")))
        if requeue:
            task.state = "ready"
            task.node = None
            task.remaining = None
            self.queue.append(task)
        else:
            task.state = "killed"
            self._unfinished -= 1

    # ------------------------------------------------- online memory sizing
    def _refresh_mem_cap(self):
        """Largest *enabled* node's memory — the ceiling for sized/escalated
        requests.  Clamping to a disabled (or failed) node's capacity would
        let escalation settle on a request no live node can host: the task
        would sit unplaceable forever instead of oom-failing.  Recomputed on
        every node disable (and at run start for pre-disabled clusters)."""
        na = self._na
        live = na.mem_gb[~na.disabled]
        self._mem_cap = float(live.max()) if live.size else 0.0

    def _size_request(self, task: TaskInstance) -> float:
        """Predicted attempt-0 request, clamped to [min_gb, largest node]."""
        if task.base_req_mem_gb is None:
            task.base_req_mem_gb = task.req_mem_gb
        pred = self._sizer.predict(self.db, task.workflow, task.name,
                                   task.base_req_mem_gb)
        return min(self._mem_cap, pred)

    def _cancel_downstream(self, instance: str):
        """A permanently-failed instance can never satisfy its dependents:
        transitively mark every still-pending dependent killed so the run
        terminates instead of deadlocking on an unreachable counter."""
        stack = [instance]
        while stack:
            for d in self._dependents.get(stack.pop(), ()):
                t = self.all_tasks[d]
                if t.state == "pending":
                    t.state = "killed"
                    self._unfinished -= 1
                    # log the cancellation (zero-duration, no node) so
                    # fairness accounting can attribute the lost subtree —
                    # silently-dropped descendants made failure-hit tenants
                    # look merely *small* instead of failed
                    self.assignment_log.append(AssignmentRecord(
                        t.instance, t.name, t.workflow, t.run_id, t.tenant,
                        "", self.t, self.t, t.req_cores, t.req_mem_gb,
                        t.submit_t, completed=False, used_mem_gb=0.0,
                        outcome="cancelled"))
                    stack.append(d)

    def _oom(self, task: TaskInstance):
        """Handle an attempt whose sampled peak exceeded its sized request.

        The attempt is killed (releasing its reservation, logging the
        partial attempt); a primary is requeued under an escalated request
        until ``max_retries`` is exhausted, after which it fails permanently
        and its downstream subtree is cancelled.  A speculative copy is
        simply dropped — the primary it was racing is still in flight.
        """
        self.sizing_stats["oom_events"] += 1
        self.sizing_stats["retry_overhead_s"] += self.t - task.start_t
        if task.speculative_of:
            self._kill(task, requeue=False, reason="oom")
            if self._spec_copies.get(task.speculative_of) == task.instance:
                del self._spec_copies[task.speculative_of]
                if self._spec_on:
                    # the primary lost its copy: it is straggler-eligible
                    # again, so restore its p95 wake state
                    s = self._task_slot.get(task.speculative_of)
                    if s is not None:
                        self._spec_p95[s] = self._spec_p95_for(
                            self.all_tasks[task.speculative_of])
            return
        failed = task.req_mem_gb
        self._sizer.observe_oom(task.workflow, task.name, failed)
        task.attempt += 1
        nxt = min(self._mem_cap,
                  self._sizer.escalate(self.db, task.workflow, task.name,
                                       failed))
        if task.attempt > self.cfg.sizing.max_retries or nxt <= failed + 1e-9:
            # retries exhausted (or the escalation is already pinned at the
            # largest enabled node's memory): permanent failure
            self.sizing_stats["oom_failures"] += 1
            self._kill(task, requeue=False, reason="oom-fail")
            task.node = None          # dead primary must not pin a node
            self._cancel_downstream(task.instance)
            self._resolve_speculative_pair(task)
        else:
            self._kill(task, requeue=True, reason="oom")
            task.req_mem_gb = nxt            # escalated, pinned for the retry
            # the retry re-runs the full work: it IS new demand, so let the
            # WFQ scheduler charge the tenant again (unlike node-failure
            # requeues, which re-place already-charged work)
            task._wfq_charged = False

    # --------------------------------------------- fault injection/recovery
    def _resolve_speculative_pair(self, task: TaskInstance):
        """A permanently-failed primary abandons its speculative copy: left
        alone, the copy would stay pinned away from the dead primary's node
        (possibly unplaceable forever) or complete into a subtree that was
        just cancelled."""
        cid = self._spec_copies.pop(task.instance, None)
        if cid is None:
            return
        copy = self.all_tasks.get(cid)
        if copy is not None:
            if copy.instance in self.running:
                self._kill(copy, requeue=False, reason="speculative-loser")
            else:
                self._drop_queued(cid)

    def _push_exo(self, t: float, kind: int, key, payload=None):
        heapq.heappush(self._exo, (t, kind, key, payload))

    def _process_exo(self):
        """Pop and apply the earliest exogenous event (the caller already
        advanced the clock to its time)."""
        _, kind, key, payload = heapq.heappop(self._exo)
        if kind == _EXO_FAIL:
            self._disable_node(key, churn=(payload == "churn"))
        elif kind == _EXO_REJOIN:
            self._rejoin_node(key)
        elif kind == _EXO_DEGRADE:
            self._degrade_node(key)
        elif kind == _EXO_RESTORE:
            self._restore_degrade(key, payload)
        else:
            self._requeue_backoff(payload)

    def _fault_retry(self, task: TaskInstance, reason: str):
        """Fault-policy kill: a crash victim, transient failure, or
        timed-out attempt consumes one unit of the instance's retry budget
        and re-queues only after exponential backoff; an exhausted budget
        is a permanent failure (``outcome="fault-fail"``) that cancels the
        downstream subtree, exactly like OOM exhaustion.  A speculative
        copy is simply dropped — the primary it raced is still in flight.
        Fault retries re-place already-charged work, so (like node-failure
        requeues, unlike OOM escalations) they are not re-charged to the
        WFQ virtual clock."""
        fm = self._faults
        self.fault_stats[_FAULT_STAT_KEY[reason]] += 1
        if task.speculative_of:
            self._kill(task, requeue=False, reason=reason)
            if self._spec_copies.get(task.speculative_of) == task.instance:
                del self._spec_copies[task.speculative_of]
                if self._spec_on:
                    # the primary lost its copy: straggler-eligible again
                    s = self._task_slot.get(task.speculative_of)
                    if s is not None:
                        self._spec_p95[s] = self._spec_p95_for(
                            self.all_tasks[task.speculative_of])
            return
        task.fault_retries += 1
        if task.fault_retries > fm.cfg.max_task_retries:
            self.fault_stats["fault_failures"] += 1
            self._kill(task, requeue=False, reason="fault-fail")
            task.node = None          # dead primary must not pin a node
            self._cancel_downstream(task.instance)
            self._resolve_speculative_pair(task)
            return
        self.fault_stats["retries"] += 1
        self._kill(task, requeue=True, reason=reason)
        delay = fm.backoff_delay(task.fault_retries)
        if delay > 0.0:
            # hold the requeued task back (it stays "ready" but leaves the
            # queue) until its backoff expiry event re-appends it
            self.fault_stats["backoff_wait_s"] += delay
            self.queue.pop()          # _kill appended it; we hold it instead
            self._backoff_until[task.instance] = self.t + delay
            self._push_exo(self.t + delay, _EXO_REQUEUE,
                           self._seq[task.instance], task.instance)

    def _requeue_backoff(self, instance: str):
        """Backoff expiry: re-queue the held retry — unless the instance was
        cancelled while it waited (speculative-pair resolution), in which
        case the expiry is a no-op."""
        if self._backoff_until.pop(instance, None) is None:
            return
        task = self.all_tasks.get(instance)
        if task is not None and task.state == "ready":
            self.queue.append(task)

    def _rejoin_node(self, name: str):
        """A churn-crashed node comes back.  Re-entry is incremental: the
        ``disabled`` property write pokes ``mask_dirty`` (repairing every
        cached feasibility mask), ``rate_stale`` refreshes its service
        rates, and ``_refresh_mem_cap`` lifts the sizing ceiling.  Bound
        scheduler arrays span *all* nodes with liveness flowing through the
        mask, so no scheduler-side rebuild exists to do (see
        ``Scheduler.bind_cluster``)."""
        if name in self._user_failed:
            return    # a permanent user failure won while the node was down
        self.fault_stats["rejoins"] += 1
        self.nodes[name].disabled = False        # pokes mask_dirty
        self._na.rate_stale[self._na.index[name]] = True
        self._refresh_mem_cap()
        nxt = self._faults.next_crash(name, self.t)
        if nxt is not None:
            self._push_exo(nxt, _EXO_FAIL, name, "churn")

    def _degrade_node(self, name: str):
        node = self.nodes[name]
        factor, duration = self._faults.degrade_params(name)
        self.fault_stats["degrades"] += 1
        old = node.slow_factor
        node.slow_factor = old * factor          # setter flags rate_stale
        self._push_exo(self.t + duration, _EXO_RESTORE, name, old)

    def _restore_degrade(self, name: str, old: float):
        self.nodes[name].slow_factor = old
        nxt = self._faults.next_degrade(name, self.t)
        if nxt is not None:
            self._push_exo(nxt, _EXO_DEGRADE, name)

    def _arm_faults(self):
        """Draw every node's first crash/degrade event (once per engine)."""
        self._faults_armed = True
        for name in self._na.names:
            if self.nodes[name].disabled:
                continue
            nxt = self._faults.next_crash(name, self.t)
            if nxt is not None:
                self._push_exo(nxt, _EXO_FAIL, name, "churn")
            nxt = self._faults.next_degrade(name, self.t)
            if nxt is not None:
                self._push_exo(nxt, _EXO_DEGRADE, name)

    def _prepare(self):
        """Build the dependency-counter state from the submitted task set.

        Runs once per `run()`; intentionally evaluated over the *final*
        contents of `all_tasks` so instance-id overwrites between multiple
        `submit()` calls resolve exactly as the seed's per-event rescan did.
        """
        self._spec_on = self.cfg.speculation   # live config, per run
        self._use_array = detect_array_path(self.scheduler,
                                            self.cfg.placement_path)
        if self._use_array:
            self.scheduler.bind_cluster(self._na, self.nodes)
        self._arm_prediction()
        self._mask_cache.clear()      # masks never survive across runs
        self._na.mask_dirty.clear()
        self._refresh_mem_cap()       # nodes may have been disabled directly
        # ingest newly-registered user failures into the exogenous-event
        # heap (kind 0 + node key reproduce the seed's (time, node)
        # processing order) and arm the fault model's churn/degrade clocks
        for ft, fnode in self._failures[self._failures_ingested:]:
            self._push_exo(ft, _EXO_FAIL, fnode, "user")
        self._failures_ingested = len(self._failures)
        if self._faults is not None and not self._faults_armed:
            self._arm_faults()
        self._deps_left = {}
        self._dependents = defaultdict(list)
        self._ready_batch = []
        self._arrivals = []
        for iid, t in self.all_tasks.items():
            if t.state != "pending":
                continue
            left = 0
            for d in t.deps:
                if d not in self.done:
                    left += 1
                    self._dependents[d].append(iid)
            self._deps_left[iid] = left
            if left == 0:
                if t.submit_t <= self.t:
                    self._ready_batch.append(iid)
                else:
                    heapq.heappush(self._arrivals,
                                   (t.submit_t, self._seq[iid], iid))
        self._unfinished = sum(1 for t in self.all_tasks.values()
                               if t.state not in ("done", "killed"))

    def _arm_prediction(self):
        """Arm the runtime-prediction subsystem (``cfg.prediction``).

        The model is the scheduler's own when it carries one
        (``PredictiveScheduler.model`` — possibly pre-warmed across runs,
        the way benches share a TraceDB), otherwise a fresh one: the
        engine then just measures, which is how the baselines get
        comparable MAPE columns.  Node groups come from the scheduler's
        phase-1 profiling when it has one (so the model's keys are
        exactly the groups the scheduler places with) and degrade to
        machine-type tiers otherwise.  A model-carrying scheduler with
        the hook off is refused loudly: its model would never observe a
        completion and it would silently place fair-forever."""
        model = getattr(self.scheduler, "model", None)
        if self.cfg.prediction is None:
            if model is not None:
                raise ValueError(
                    "scheduler carries a runtime-prediction model but "
                    "EngineConfig.prediction is None — the model would "
                    "never observe a completion; set "
                    "EngineConfig.prediction=PredictionConfig()")
            return
        if self._predictor is not None:        # re-runs / restored engines
            return
        self._predictor = model if model is not None \
            else make_predictor(self.cfg.prediction)
        info = getattr(self.scheduler, "info", None)
        groups = getattr(info, "node_group", None)
        if groups is not None:
            self._pred_group = dict(groups)
        else:
            machines = sorted({sn.spec.machine for sn in self.nodes.values()})
            tier = {m: i for i, m in enumerate(machines)}
            self._pred_group = {name: tier[sn.spec.machine]
                                for name, sn in self.nodes.items()}

    def _promote_ready(self):
        while self._arrivals and self._arrivals[0][0] <= self.t:
            self._ready_batch.append(heapq.heappop(self._arrivals)[2])
        if not self._ready_batch:
            return
        # promote in submission order: identical to the seed's in-order
        # rescan of all_tasks (dict overwrites keep first-insert position)
        batch = sorted(set(self._ready_batch), key=self._seq.__getitem__)
        self._ready_batch.clear()
        for iid in batch:
            t = self.all_tasks[iid]
            if t.state == "pending":
                t.state = "ready"
                self.queue.append(t)

    def _schedule(self):
        if self._sizer is not None:
            # re-size attempt-0 requests every pass (predictions sharpen as
            # the monitor ingests traces; memoized per history epoch so a
            # stable queue costs dict hits).  Schedulers then *place against
            # the predicted request*: _feasible and SimNode.load() read
            # req_mem_gb, so Tarema/weighted-Tarema group picks and
            # least-loaded tie-breaks all see the sized value.  Escalated
            # retry requests (attempt > 0) are pinned in _oom.
            for task in self.queue:
                if task.attempt == 0:
                    task.req_mem_gb = self._size_request(task)
        self.queue = self.scheduler.order(self.queue, self.db)
        if self._use_array:
            self._place_array()
        else:
            self._place_dict()

    def _place_dict(self):
        """Per-task dict placement — the compatibility fallback for external
        schedulers that only implement select_node."""
        self._na.mask_dirty.clear()   # no cached masks to repair on this path
        still = []
        for task in self.queue:
            node = self.scheduler.select_node(
                task, self.nodes, self._feasible(task), self.db)
            if node is None:
                still.append(task)
            else:
                self._start(task, node)
        self.queue = still

    def _place_array(self):
        """Array-native placement pass (same observable behaviour as
        _place_dict, pinned bit-for-bit by the parity/equivalence suites).

        One feasibility mask per distinct (req_cores, req_mem_gb) demand is
        kept *across* passes and maintained incrementally: placements,
        finishes, kills and disables append their node to ``na.mask_dirty``
        (a placement within a pass only changes its own node), so consuming
        cores/mem is an index poke into each cached mask instead of a
        per-task O(nodes) dict rebuild — a finish event repairs a couple of
        entries rather than rebuilding anything.  Speculative-pair
        exclusions are poke+restore on the shared mask.  A scheduler is
        only invoked when the mask is non-empty — a failed dict-path select
        never draws RNG or mutates state, so skipping the call is
        stream-identical.  The blocked-queue early exit stops the scan once
        no enabled node can host even the smallest (cores, mem) demand
        remaining below the cursor: placements only shrink free resources
        within a pass, so everything deeper is unplaceable and a saturated
        50k-deep queue stops costing O(queue x nodes) per event.
        """
        na, sched, q = self._na, self.scheduler, self.queue
        still: list[TaskInstance] = []
        mask_cache = self._mask_cache
        if na.mask_dirty:
            dirty = na.mask_dirty
            if len(dirty) * len(mask_cache) > 4 * len(na.names):
                mask_cache.clear()          # cheaper to rebuild on demand
            else:
                for (rc, rm), m in mask_cache.items():
                    for i in dirty:
                        m[i] = na.feasible_at(i, rc, rm)
            dirty.clear()
        suffix_rc = suffix_rm = None
        nq = len(q)
        k = 0
        while k < nq:
            task = q[k]
            key = (task.req_cores, task.req_mem_gb)
            mask = mask_cache.get(key)
            if mask is None:
                mask = na.feasible_mask(task.req_cores, task.req_mem_gb)
                if len(mask_cache) < 64:   # sizing can make demands unique
                    mask_cache[key] = mask
            j = self._spec_excluded_idx(task)
            restore = j >= 0 and bool(mask[j])
            if restore:
                mask[j] = False
            node_i = sched.select_node_idx(task, mask, self.db) \
                if mask.any() else None
            if restore:
                mask[j] = True
            if node_i is None:
                still.append(task)
                if suffix_rc is None:
                    suffix_rc, suffix_rm = suffix_min_demand(q)
                if k + 1 < nq:
                    nxt = (suffix_rc[k + 1], suffix_rm[k + 1])
                    # the common saturated case: the suffix min IS this
                    # task's demand, whose mask we just saw empty
                    blocked = nxt == key if not mask.any() else False
                    if not blocked and not na.feasible_mask(
                            suffix_rc[k + 1], suffix_rm[k + 1]).any():
                        blocked = True
                    if blocked:
                        still.extend(q[k + 1:])
                        break
            else:
                self._start(task, na.names[node_i])
                # _start marked node_i dirty for the *next* pass; this pass
                # repairs its own masks right away
                na.mask_dirty.clear()
                for (rc, rm), m in mask_cache.items():
                    m[node_i] = na.feasible_at(node_i, rc, rm)
            k += 1
        self.queue = still

    def _spec_p95_for(self, task: TaskInstance) -> float:
        """Current straggler threshold input for a running task: its p95
        historic runtime, or 0.0 when ineligible (a copy never speculates;
        a primary with a live copy already did) — 0.0 reproduces the seed's
        falsy-p95 guard exactly."""
        if task.speculative_of or task.instance in self._spec_copies:
            return 0.0
        p95 = self.db.runtime_quantile(task.workflow, task.name, 0.95,
                                       method=self.cfg.quantile_method)
        return p95 or 0.0

    def _respec_name(self, workflow: str, name: str):
        for s in self._name_slots.get((workflow, name), ()):
            if self._slot_active[s]:
                self._spec_p95[s] = self._spec_p95_for(self._slot_tasks[s])

    def _maybe_speculate(self):
        if not self.cfg.speculation:
            return
        # vectorized straggler scan over the slot SoA: the seed looped over
        # `running` re-reading each task's p95 every event.  Ascending slot
        # order == running-dict insertion order, so copies are queued in
        # the same order; the comparison keeps the seed's exact operand
        # shape ((t - start) > factor * p95, elementwise).
        n = self._n_slots
        p95 = self._spec_p95[:n]
        fire = (self._slot_active[:n] & (p95 > 0.0)
                & ((self.t - self._slot_start[:n])
                   > self.cfg.speculation_factor * p95))
        for s in np.flatnonzero(fire):
            task = self._slot_tasks[s]
            copy = dataclasses.replace(
                task, instance=f"{task.instance}~spec{self._uid}",
                state="ready", node=None, remaining=None,
                speculative_of=task.instance)
            self._uid += 1
            self._seq[copy.instance] = self._seq_next
            self._seq_next += 1
            self.all_tasks[copy.instance] = copy
            self._deps_left[copy.instance] = 0
            self._unfinished += 1
            self.queue.append(copy)
            self._spec_copies[task.instance] = copy.instance
            self._spec_p95[s] = 0.0      # has a copy now: ineligible

    def _drop_queued(self, instance: str) -> bool:
        """Cancel a ready-but-not-started instance (speculative pair
        resolution): remove it from the queue before it runs redundantly.
        Only a task actually removed from the queue is marked killed —
        anything else would leave a killed task schedulable (and its later
        finish would drive ``_unfinished`` negative)."""
        t = self.all_tasks.get(instance)
        if t is None or t.state != "ready":
            return False
        if self._backoff_until.pop(instance, None) is not None:
            # held in retry backoff, not queued: its expiry event no-ops
            t.state = "killed"
            self._unfinished -= 1
            return True
        try:
            self.queue.remove(t)
        except ValueError:      # not queued after all: leave it untouched
            return False
        t.state = "killed"
        self._unfinished -= 1
        return True

    def _disable_node(self, name: str, churn: bool = False):
        node = self.nodes[name]
        if churn:
            # fault-model crash: victims consume retry budget + backoff,
            # and the node rejoins after a drawn downtime
            if node.disabled:
                return   # user failure already took it down permanently
            na, fm = self._na, self._faults
            if len(na.names) - int(na.disabled.sum()) <= fm.cfg.min_live_nodes:
                # below the survivor floor: skip this crash but keep the
                # node's churn clock running
                nxt = fm.next_crash(name, self.t)
                if nxt is not None:
                    self._push_exo(nxt, _EXO_FAIL, name, "churn")
                return
            self.fault_stats["crashes"] += 1
            node.disabled = True
            self._refresh_mem_cap()
            # victims in *slot* (start) order, NOT set order: a restored
            # engine's unpickled sets can iterate differently from the
            # original's (hash-table history), and kill order decides
            # requeue order — snapshot bit-equivalence needs it stable.
            # (The user-failure path below deliberately keeps the seed's
            # set iteration: it is pinned bit-for-bit against engine_ref,
            # which walks the same identically-built set.)
            i = na.index[name]
            n = self._n_slots
            for s in np.flatnonzero(self._slot_active[:n]
                                    & (self._slot_node[:n] == i)):
                victim = self._slot_tasks[s]
                if victim is not None:   # freed by a sibling's pair resolution
                    self._fault_retry(victim, "node-crash")
            self._push_exo(self.t + fm.downtime(name), _EXO_REJOIN, name)
            return
        node.disabled = True
        self._refresh_mem_cap()
        for tid in list(node.running):
            self._kill(self.running[tid], requeue=True)

    # ------------------------------------------------------------------ run
    def run(self, max_t: float = 10_000_000.0,
            until: Optional[float] = None) -> dict:
        """Run to completion — or, with ``until``, pause at the first event
        boundary at or past that time (``result["paused"]`` is True when
        work remains).  A paused engine resumes with another ``run()``
        call, possibly after a ``snapshot()``/``restore()`` round-trip in a
        different process; the pause never splits a floating-point task
        advance, so the resumed trace is bit-for-bit identical to an
        uninterrupted run (pinned by tests/test_faults.py)."""
        with np.errstate(divide="ignore"):
            return self._run_loop(max_t, until)

    def _run_loop(self, max_t: float, until: Optional[float] = None) -> dict:
        # one blanket divide-only errstate for the whole loop (zero-rate
        # divisions in the time-left/advance math are intentional) instead
        # of a context manager entered per event; *invalid* warnings stay
        # live as a guardrail (a NaN reaching scheduler/monitor/sizing math
        # is always a bug) — dead slots can't produce 0/0 because their
        # remaining-work rows are zeroed on release
        t_run0 = time.perf_counter()
        self._sched_wall = self._monitor_wall = 0.0   # per-run attribution
        self._prepare()
        paused = False
        while True:
            if until is not None and self.t >= until and self._unfinished > 0:
                paused = True
                break
            self._promote_ready()
            t0 = time.perf_counter()
            self._schedule()
            self._sched_wall += time.perf_counter() - t0
            self._maybe_speculate()
            if not self.running:
                if self._unfinished == 0:
                    break
                # nothing running but work remains: jump to the next
                # exogenous event (node failure/rejoin, backoff requeue, or
                # delayed submission)
                next_exo = self._exo[0][0] if self._exo else None
                next_arr = self._arrivals[0][0] if self._arrivals else None
                if next_exo is None and next_arr is None:
                    raise RuntimeError("tasks stuck with no runnable node")
                if next_arr is not None and \
                        (next_exo is None or next_arr <= next_exo):
                    self.t = max(self.t, next_arr)
                else:
                    self.t = max(self.t, next_exo)
                    self._process_exo()
                # uniform runaway guard: *every* time advance checks max_t
                # (the arrival jump used to continue unchecked, and the
                # exogenous checks were gated on a fault model being
                # present — a plain tenancy stream stretching past max_t
                # never raised until its first finish)
                if self.t > max_t:
                    raise RuntimeError("simulation exceeded max_t")
                continue
            # next event: earliest finishing task, next failure, or the next
            # speculation check (without it the loop can jump straight past
            # the straggler threshold).  All slot math runs over the full
            # (kept-dense) slot range — contiguous vectorized ops, no
            # per-event index gather/scatter; dead slots carry garbage that
            # the active mask screens out of the argmin.
            n = self._n_slots
            act = self._slot_active[:n]
            tl = self._time_left_full(n)
            tlm = np.where(act, tl, np.inf)
            j = int(np.argmin(tlm))     # first min == dict-order tie-break
            if not act[j]:              # min is +inf and landed on a dead
                cand = np.flatnonzero(act)   # slot: first *active* inf wins
                j = int(cand[np.argmin(tlm[cand])])
            dt = tl[j]
            finishing: Optional[TaskInstance] = self._slot_tasks[j]
            if self.cfg.speculation:
                # earliest straggler wake-up from the cached p95 slot state
                # (the seed re-read every running task's quantile here);
                # operand order matches the seed's wake expression exactly
                p95a = self._spec_p95[:n]
                el = act & (p95a > 0.0)
                if el.any():
                    wakes = (self._slot_start[:n][el]
                             + self.cfg.speculation_factor * p95a[el]
                             + 1e-6) - self.t
                    wakes = wakes[(wakes > 0) & (wakes < dt)]
                    if wakes.size:
                        finishing, dt = None, wakes.min()
            reap = -1
            if self._faults is not None and self._faults.has_timeouts:
                # earliest wall-clock kill deadline among running attempts
                # competes with finish/wake events; +inf deadlines (no
                # policy match or no history yet) never fire
                dl = np.where(act, self._slot_deadline[:n], np.inf)
                jd = int(np.argmin(dl))
                ddl = dl[jd] - self.t
                if ddl < dt:
                    finishing, dt, reap = None, max(ddl, 0.0), jd
            t_next = self.t + dt
            if self._exo and self._exo[0][0] < t_next:
                et = self._exo[0][0]
                self._advance_full(max(et - self.t, 0.0), n, tl)
                self.t = et
                self._process_exo()
                if self.t > max_t:
                    raise RuntimeError("simulation exceeded max_t")
                continue
            self._advance_full(dt, n, tl)
            self.t = float(t_next)
            if reap >= 0:              # timeout: reap the hung attempt
                self._fault_retry(self._slot_tasks[reap], "timeout")
                self._maybe_compact()
                if self.t > max_t:
                    raise RuntimeError("simulation exceeded max_t")
                continue
            if finishing is None:      # speculation wake-up, nothing finished
                continue
            task = finishing
            if getattr(task, "_oom_doomed", False):
                # the "finish" of an under-sized attempt is its OOM point:
                # kill + escalate + retry instead of completing
                self._oom(task)
                self._maybe_compact()
                if self.t > max_t:
                    raise RuntimeError("simulation exceeded max_t")
                continue
            if getattr(task, "_fault_doomed", False):
                # the "finish" of a doomed attempt is its transient-failure
                # point: consume a retry + backoff instead of completing
                self._fault_retry(task, "task-failure")
                self._maybe_compact()
                if self.t > max_t:
                    raise RuntimeError("simulation exceeded max_t")
                continue
            self._finish(task)
            # speculative pair resolution: first finisher wins.  The loser
            # may be running (seed semantics: kill it) or still *queued* —
            # a copy the scheduler hasn't placed yet, or a primary requeued
            # by a node failure while its copy ran.  The seed leaves queued
            # losers to execute redundantly; `cancel_stale_speculative`
            # drops them instead (see EngineConfig).
            other = self._spec_copies.pop(task.speculative_of or task.instance, None)
            if task.speculative_of:
                orig = task.speculative_of
                if orig in self.running:
                    self._kill(self.running[orig], requeue=False)
                    self.done[orig] = task  # result available
                    self._on_done(orig)
                elif self.cfg.cancel_stale_speculative \
                        and self._drop_queued(orig):
                    self.done[orig] = task  # result available
                    self._on_done(orig)
            elif other:
                if other in self.running:
                    self._kill(self.running[other], requeue=False)
                elif self.cfg.cancel_stale_speculative:
                    self._drop_queued(other)
            self._maybe_compact()
            if self.t > max_t:
                raise RuntimeError("simulation exceeded max_t")
        # per-phase wall breakdown (scheduling = order + placement passes,
        # monitor = TraceDB ingestion, event = everything else in the loop)
        total = time.perf_counter() - t_run0
        self.phase_wall = {
            "schedule_s": self._sched_wall,
            "monitor_s": self._monitor_wall,
            "event_s": max(total - self._sched_wall - self._monitor_wall, 0.0),
        }
        return {"makespan": self._max_end, "assignments": self.assignments,
                "paused": paused}

    # ------------------------------------------------- snapshot / restore
    def snapshot(self) -> bytes:
        """Serialize the complete engine state to bytes: node SoA, queues,
        running slots, engine + scheduler RNG state, fault-model streams,
        WFQ virtual clocks, and the TraceDB epoch.  Call between ``run()``
        calls (e.g. paused via ``run(until=t)``) — never mid-event.
        ``restore`` rebuilds an engine in any process that resumes
        bit-for-bit identically to the uninterrupted run; pure memo caches
        (scheduler labels/quantiles) are dropped on the way out and rebuilt
        on demand, so they cost no blob space and no determinism."""
        return pickle.dumps({"version": _SNAPSHOT_VERSION, "engine": self},
                            protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def restore(blob: bytes) -> "Engine":
        state = pickle.loads(blob)
        if not isinstance(state, dict) \
                or state.get("version") != _SNAPSHOT_VERSION \
                or not isinstance(state.get("engine"), Engine):
            raise ValueError("not a compatible engine snapshot")
        return state["engine"]
