"""The five schedulers of the evaluation (§V-E-a).

Baselines: Round-Robin (default Kubernetes behaviour), Fair (YARN/Slurm-style
least-reserved), Fill-Nodes (pack a node before moving on), and SJFN
(shortest job -> fastest node, fed by the same monitoring data Tarema uses).
Tarema: phase-1 profiling groups + phase-2 task labels + phase-3 scoring
allocation, falling back to fair placement for unknown tasks.

Interface consumed by workflow.engine.Engine:
    order(queue, db) -> reordered queue
    select_node(task, nodes, feasible, db) -> node name | None

Array-native fast path (opt-in via ``supports_array_placement``): the engine
binds its node structure-of-arrays once per run (``bind_cluster(na, nodes)``)
and then places through ``select_node_idx(task, mask, db) -> node index``,
where ``mask`` is a numpy feasibility bitmap over node indices.  Every
built-in scheduler implements it as a masked argmin/argsort over
pre-bound per-node arrays — no per-placement dicts, list-comps, or
re-sorts — while drawing tie-break randoms in exactly the dict path's
order, so both paths are bit-for-bit interchangeable (pinned by
``tests/test_scheduler_protocol.py`` and the equivalence suite).  External
schedulers that only implement ``select_node`` keep working: the engine
feature-detects and falls back to the dict path.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from repro_torch.core import allocation, labeling
from repro_torch.core.clustering import choose_k
from repro_torch.core.monitor import TraceDB
from repro_torch.core.prediction import PredictionConfig, make_predictor
from repro_torch.core.profiler import NodeProfile, profile_cluster_synthetic
from repro_torch.device import resolve_device


class Scheduler:
    name = "base"
    # Array-path opt-in.  The engine additionally verifies (by MRO depth)
    # that a subclass overriding select_node also overrides
    # select_node_idx — otherwise the array path would silently bypass the
    # customized dict semantics — and falls back to the dict path if not.
    supports_array_placement = False

    def bind_cluster(self, na, nodes) -> None:
        """Bind the engine's node SoA (``na``) + SimNode view (``nodes``)
        for the array fast path.  Called once per run; idempotent.

        Churn contract (``repro.workflow.faults``): the bound arrays span
        *all* nodes for the run's lifetime — a crashed node stays in them
        and liveness flows exclusively through the feasibility ``mask``
        (``na.disabled`` zeroes its column), so node crash/rejoin cycles
        need no re-bind and Tarema's group index arrays stay valid.  This
        identity check also makes the bind a no-op after
        ``Engine.restore``: the scheduler and engine are pickled as one
        object graph, so ``self._na is na`` survives the round trip."""
        if getattr(self, "_na", None) is not na:
            self._na = na
            self._sim_nodes = nodes
            self._on_bind(na)

    def _on_bind(self, na) -> None:
        """Hook for per-cluster derived arrays (rank permutations, speed
        columns, group index arrays)."""

    def __getstate__(self):
        """Snapshot support (``Engine.snapshot``): drop the pure memo
        caches — labels, runtime estimates, group priorities and score
        vectors are epoch-keyed pure reads rebuilt on demand, so shipping
        them only bloats the blob.  Stateful fields (round-robin cursor,
        WFQ virtual clocks, live allocations, tie-break RNGs) are kept:
        they ARE the schedule."""
        d = self.__dict__.copy()
        for cache in ("_label_cache", "_priority_cache", "_scores_cache",
                      "_est_cache"):
            if cache in d:
                d[cache] = {}
        if "_est_key" in d:
            d["_est_key"] = None
        return d

    def order(self, queue, db: TraceDB):
        return queue

    def select_node(self, task, nodes, feasible, db: TraceDB):
        raise NotImplementedError


class RoundRobinScheduler(Scheduler):
    """Cycle through the (shuffled) node list; skip infeasible nodes."""
    name = "roundrobin"
    supports_array_placement = True

    def __init__(self, node_names, seed: int = 0):
        self.nodes = list(node_names)
        np.random.default_rng(seed).shuffle(self.nodes)
        self._i = 0

    def select_node(self, task, nodes, feasible, db):
        for k in range(len(self.nodes)):
            cand = self.nodes[(self._i + k) % len(self.nodes)]
            if feasible.get(cand):
                self._i = (self._i + k + 1) % len(self.nodes)
                return cand
        return None

    def _on_bind(self, na):
        # shuffled-list position -> node index
        self._perm = np.array([na.index[n] for n in self.nodes], np.int64)

    def select_node_idx(self, task, mask, db):
        # rotated-mask scan: first feasible shuffled-list position >= _i,
        # wrapping — identical to the dict path's modular probe loop
        live = np.flatnonzero(mask[self._perm])
        if live.size == 0:
            return None
        pos = int(np.searchsorted(live, self._i))
        j = int(live[pos]) if pos < live.size else int(live[0])
        self._i = (j + 1) % len(self.nodes)
        return int(self._perm[j])


class FairScheduler(Scheduler):
    """Least-reserved node first (YARN fair / Slurm default flavour).
    Ties break randomly — the paper shuffles node lists between runs so no
    scheduler is accidentally speed-aware through list order."""
    name = "fair"
    supports_array_placement = True

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def select_node(self, task, nodes, feasible, db):
        cands = [n for n, ok in feasible.items() if ok]
        if not cands:
            return None
        return min(cands, key=lambda n: (nodes[n].load(), self.rng.random()))

    def select_node_idx(self, task, mask, db):
        cand = np.flatnonzero(mask)
        if cand.size == 0:
            return None
        return allocation.least_loaded_idx(self._na, cand, self.rng)


class FillNodesScheduler(Scheduler):
    """Fully claim a node before assigning to the next one in the list."""
    name = "fillnodes"
    supports_array_placement = True

    def __init__(self, node_names, seed: int = 0):
        self.nodes = list(node_names)
        np.random.default_rng(seed).shuffle(self.nodes)
        # name -> shuffled-list rank; the seed did `self.nodes.index(n)`
        # inside the sort key, an O(n^2) comparator at fleet scale
        self._rank = {n: i for i, n in enumerate(self.nodes)}

    def select_node(self, task, nodes, feasible, db):
        # prefer partially-filled feasible nodes, then list order
        for cand in sorted(self.nodes,
                           key=lambda n: (nodes[n].free_cores == nodes[n].spec.cores,
                                          self._rank[n])):
            if feasible.get(cand):
                return cand
        return None

    def _on_bind(self, na):
        self._rank_arr = np.array([self._rank[n] for n in na.names], np.int64)

    def select_node_idx(self, task, mask, db):
        # the dict path re-sorts every node per placement just to take the
        # first feasible one; the winner is simply the feasible argmin of
        # (is-empty, rank) — rank is unique, so one flat integer key does it
        cand = np.flatnonzero(mask)
        if cand.size == 0:
            return None
        na = self._na
        empty = na.free_cores[cand] == na.cores[cand]
        key = np.where(empty, len(self.nodes), 0) + self._rank_arr[cand]
        return int(cand[np.argmin(key)])


class _ProfiledScheduler(Scheduler):
    """Shared phase-1 state: profiles, groups, labels.

    ``profiles`` overrides the synthetic phase-1 benchmarks with externally
    *measured* ones (the real-execution backend profiles its nodes via
    ``profile_local`` / ``selfhost.profile_backend``); grouping/labeling
    are identical either way.  One profile per spec, same node names.

    ``device`` is where grouping (``choose_k``) and group scoring
    (``allocation``) run: CUDA by default, ``"cpu"`` on request."""

    def __init__(self, specs, seed: int = 0,
                 profiles: list[NodeProfile] | None = None, device=None):
        self.device = resolve_device(device)
        self.profiles: list[NodeProfile] = list(profiles) \
            if profiles is not None else profile_cluster_synthetic(specs, seed)
        X = np.stack([p.vector() for p in self.profiles])
        self.grouping = choose_k(X, k_max=6, device=self.device)
        self.info = labeling.build_group_info(self.profiles, self.grouping["labels"])
        # fastest-first node order by measured cpu speed (for SJFN)
        self.by_speed = [p.node for p in
                         sorted(self.profiles, key=lambda p: -p.features["cpu"])]
        self._label_cache: dict = {}     # (wf, task, db.version) -> labels

    def task_labels(self, db, workflow: str, task_name: str):
        """`labeling.label_task` memoized per history epoch.

        Labels only change when the monitor ingests a new trace, so keying
        the memo on the store generation + ``db.version`` keeps results
        identical to recomputing while turning the per-placement cost into
        a dict hit (``db.uid`` guards against version collisions across
        ``clear()`` or a scheduler reused with a different TraceDB).
        """
        key = (workflow, task_name, db.uid, db.version)
        if key not in self._label_cache:
            if len(self._label_cache) > 65536:     # epoch churn backstop
                self._label_cache.clear()
            self._label_cache[key] = labeling.label_task(
                db, self.info, workflow, task_name)
        return self._label_cache[key]


class SJFNScheduler(_ProfiledScheduler):
    """Shortest-Job-Fastest-Node: order the queue by estimated runtime
    (historic mean from the monitor), place on the fastest feasible node.
    Nodes of the same machine type benchmark identically, so speed ties
    break to the least-loaded node (then randomly)."""
    name = "sjfn"
    supports_array_placement = True

    def __init__(self, specs, seed: int = 0, profiles=None, device=None):
        super().__init__(specs, seed, profiles, device)
        self.rng = np.random.default_rng(seed + 2)
        self.speed = {p.node: p.features["cpu"] for p in self.profiles}
        self._est_key = None         # (db.uid, db.version) behind _est_cache
        self._est_cache: dict = {}   # (wf, task name) -> runtime estimate

    def order(self, queue, db):
        if len(queue) < 2:
            return queue
        # stable argsort over a per-task-name estimate column, memoized per
        # history epoch — the dict path called db.mean_runtime once per
        # *task instance* per pass (50k Python calls per event at fleet
        # scale); names repeat, so one dict hit per instance remains
        key = (db.uid, db.version)
        if self._est_key != key:
            self._est_key, self._est_cache = key, {}
        cache = self._est_cache
        est = np.empty(len(queue), np.float64)
        for i, t in enumerate(queue):
            k = (t.workflow, t.name)
            v = cache.get(k)
            if v is None:
                r = db.mean_runtime(*k)
                cache[k] = v = r if r is not None else np.inf
            est[i] = v
        idx = np.argsort(est, kind="stable")    # == sorted(queue, key=est)
        return [queue[i] for i in idx]

    def select_node(self, task, nodes, feasible, db):
        cands = [n for n, ok in feasible.items() if ok]
        if not cands:
            return None
        # fastest first; equal-speed (same machine type) -> least loaded
        return min(cands, key=lambda n: (-round(self.speed[n], -1),
                                         nodes[n].load(), self.rng.random()))

    def _on_bind(self, na):
        # the dict path's primary sort key, pre-negated and pre-rounded
        self._negspeed = np.array([-round(self.speed[n], -1)
                                   for n in na.names], np.float64)

    def select_node_idx(self, task, mask, db):
        cand = np.flatnonzero(mask)
        if cand.size == 0:
            return None
        loads = allocation.node_loads(self._na, cand)
        ties = self.rng.random(cand.size)
        order = np.lexsort((ties, loads, self._negspeed[cand]))
        return int(cand[order[0]])


class TaremaScheduler(_ProfiledScheduler):
    """Phase 3: score-based group allocation, least-loaded node in group,
    fair fallback for unknown tasks (paper §IV-D)."""
    name = "tarema"
    supports_array_placement = True

    def __init__(self, specs, seed: int = 0, profiles=None, device=None):
        super().__init__(specs, seed, profiles, device)
        self.rng = np.random.default_rng(seed + 1)
        self._priority_cache: dict = {}  # label vector -> group priority list

    def _cached_priority(self, labels) -> list:
        key = tuple(sorted(labels.items()))
        priority = self._priority_cache.get(key)
        if priority is None:
            priority = allocation.priority_groups(self.info, labels,
                                                  self.device)
            self._priority_cache[key] = priority
        return priority

    def select_node(self, task, nodes, feasible, db):
        labels = self.task_labels(db, task.workflow, task.name)
        priority = self._cached_priority(labels) if labels is not None else None
        load = {n: nodes[n].load() for n in nodes}
        return allocation.pick_node(self.info, labels, load, feasible, self.rng,
                                    priority=priority)

    def select_node_idx(self, task, mask, db):
        labels = self.task_labels(db, task.workflow, task.name)
        priority = self._cached_priority(labels) if labels is not None else None
        return allocation.pick_node_idx(self.info, labels, self._na, mask,
                                        self.rng, priority=priority)


class WeightedTaremaScheduler(TaremaScheduler):
    """Tenant-weighted Tarema for multi-tenant streams (§V-F, tenancy.py).

    Two additions over the paper's phase 3, both reducing to vanilla Tarema
    when a single tenant owns the cluster:

      * **queue order** is weighted-fair-queuing virtual time: every
        successful placement charges its tenant ``cores * est_runtime /
        weight`` (historic mean runtime from the monitor, 1.0 for unknown
        tasks), and the queue drains lowest-virtual-time tenant first — a
        backlogged heavy-weight tenant cannot lock out light ones;
      * **group priority** folds current usage in: the tenant's live share
        of running cores is compared against its weighted entitlement, and
        an over-share tenant has group scores inflated by
        ``pressure * overuse * group_power`` (see
        ``allocation.weighted_priority_groups``), steering its surplus onto
        weaker groups so the strong groups stay available for under-served
        tenants.

    Live usage is reconstructed from the nodes' running sets against the
    allocations this scheduler made (lazily purged), so per-placement work
    stays O(running tasks) = O(nodes) — within the ROADMAP budget.
    """
    name = "weighted-tarema"

    def __init__(self, specs, seed: int = 0, weights: dict | None = None,
                 pressure: float = 1.0, share_tolerance: float = 0.02,
                 profiles=None, device=None):
        super().__init__(specs, seed, profiles, device)
        self.weights = dict(weights or {})
        self.pressure = pressure
        self.share_tolerance = share_tolerance
        self._virtual = defaultdict(float)   # tenant -> served work / weight
        self._alloc = {}                     # instance -> (tenant, cores, node)
        # label vector -> base task_scores; bounded by the few distinct
        # label combinations (values 1..n_groups per feature)
        self._scores_cache: dict = {}

    def _weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    def order(self, queue, db):
        # stable sort: under-served tenants first, submission order within
        if len(queue) < 2:
            return queue
        vt = np.fromiter(
            (self._virtual[getattr(t, "tenant", "default")] for t in queue),
            np.float64, len(queue))
        idx = np.argsort(vt, kind="stable")
        return [queue[i] for i in idx]

    def _live_cores(self, nodes) -> dict:
        """Running cores per tenant from this scheduler's own allocations,
        purging entries whose instance already left its node."""
        used: dict = defaultdict(float)
        dead = []
        for iid, (tenant, cores, node) in self._alloc.items():
            if iid in nodes[node].running:
                used[tenant] += cores
            else:
                dead.append(iid)
        for iid in dead:
            del self._alloc[iid]
        return used

    def _overuse(self, tenant: str, nodes) -> float:
        used = self._live_cores(nodes)
        total = sum(used.values())
        if total <= 0.0:
            return 0.0
        wsum = sum(self._weight(t) for t in set(used) | {tenant})
        entitled = self._weight(tenant) / wsum if wsum > 0 else 1.0
        return used.get(tenant, 0.0) / total - entitled - self.share_tolerance

    def _priority_for(self, task, tenant, labels, nodes):
        """Group priority list for one placement (None for unlabeled tasks):
        the paper's ordering at/under share, usage-penalized above it.
        Shared by the dict and array paths."""
        if labels is None:
            return None
        overuse = self._overuse(tenant, nodes)
        if overuse <= 0.0:
            # at/under share this is exactly the paper's ordering, so
            # reuse the parent's per-label-vector memo
            return self._cached_priority(labels)
        # base scores are overuse-independent: memoize the device
        # dispatch, pay only the numpy penalty + sort per placement
        key = tuple(sorted(labels.items()))
        base = self._scores_cache.get(key)
        if base is None:
            base = allocation.task_scores(self.info, labels, self.device)
            self._scores_cache[key] = base
        return allocation.weighted_priority_groups(
            self.info, labels, overuse, self.pressure, base_scores=base,
            device=self.device)

    def _charge_placement(self, task, tenant, node, db, nodes):
        """Post-placement bookkeeping (both paths).

        WFQ-charge each logical task once: re-placements after a node
        failure and speculative copies are not new demand, and must
        not push their (victim) tenant further back in the queue.
        OOM retries (EngineConfig.sizing) ARE new demand — the retry
        re-runs the full work — so the engine clears the flag when it
        requeues an OOM'd attempt and the tenant is charged again.
        The charged flag lives on the task object so its lifetime is
        exactly the instance's (no unbounded scheduler-side set).
        """
        if not getattr(task, "_wfq_charged", False) \
                and not task.speculative_of:
            est = db.mean_runtime(task.workflow, task.name) or 1.0
            # stride-scheduling catch-up: an idle/late tenant resumes at
            # the *live* tenants' virtual-time floor instead of from its
            # stale (tiny) value, so banked idle time cannot be spent
            # monopolizing the queue on arrival.  Purge first: the live
            # set must be a function of engine state, not of how many
            # placement probes happened to run purges earlier (the array
            # path legitimately skips probes for infeasible tasks).
            self._live_cores(nodes)
            active = {t for (t, _, _) in self._alloc.values()} - {tenant}
            floor = min((self._virtual[t] for t in active),
                        default=self._virtual[tenant])
            self._virtual[tenant] = \
                max(self._virtual[tenant], floor) \
                + task.req_cores * est / self._weight(tenant)
            task._wfq_charged = True
        self._alloc[task.instance] = (tenant, task.req_cores, node)

    def select_node(self, task, nodes, feasible, db):
        tenant = getattr(task, "tenant", "default")
        labels = self.task_labels(db, task.workflow, task.name)
        priority = self._priority_for(task, tenant, labels, nodes)
        load = {n: nodes[n].load() for n in nodes}
        node = allocation.pick_node(self.info, labels, load, feasible,
                                    self.rng, priority=priority)
        if node is not None:
            self._charge_placement(task, tenant, node, db, nodes)
        return node

    def select_node_idx(self, task, mask, db):
        tenant = getattr(task, "tenant", "default")
        labels = self.task_labels(db, task.workflow, task.name)
        priority = self._priority_for(task, tenant, labels, self._sim_nodes)
        i = allocation.pick_node_idx(self.info, labels, self._na, mask,
                                     self.rng, priority=priority)
        if i is not None:
            self._charge_placement(task, tenant, self._na.names[i], db,
                                   self._sim_nodes)
        return i


class PredictiveScheduler(_ProfiledScheduler):
    """Completion-time placement over the learned runtime/interference
    model (``repro_torch.core.prediction``, Reshi-style §beyond-paper).

    Each placement scores every feasible node with the model's predicted
    completion seconds — hierarchical (task, node-group) base runtime
    times the fitted co-residency slowdown factor for the node's current
    occupancy — and takes the minimum; the node-ready term of the
    completion time is zero for every candidate, because the engine only
    offers nodes that can host the task *now*.  Ties break by load, then
    randomly, exactly like SJFN.  A completely cold model (no completed
    observation anywhere) falls back to fair least-loaded placement, the
    same unknown-task rule Tarema uses.

    The model only learns when the engine feeds it completions, so this
    scheduler requires ``EngineConfig.prediction``; the engine refuses a
    model-carrying scheduler without the hook rather than silently
    running fair-forever.  Pass ``model=`` to share a warm model across
    runs (benchmarks warm it exactly like they share a ``TraceDB``).
    """
    name = "predictive"
    supports_array_placement = True

    def __init__(self, specs, seed: int = 0,
                 config: PredictionConfig | None = None, model=None,
                 profiles=None, device=None):
        super().__init__(specs, seed, profiles, device)
        self.rng = np.random.default_rng(seed + 4)
        self.model = model if model is not None \
            else make_predictor(config or PredictionConfig())

    def select_node(self, task, nodes, feasible, db):
        cands = [n for n, ok in feasible.items() if ok]
        if not cands:
            return None
        groups = [self.info.node_group[n] for n in cands]
        running = [len(nodes[n].running) for n in cands]
        scores = self.model.placement_scores(task.workflow, task.name,
                                             groups, running)
        if scores is None:
            return min(cands,
                       key=lambda n: (nodes[n].load(), self.rng.random()))
        idx = min(range(len(cands)),
                  key=lambda i: (scores[i], nodes[cands[i]].load(),
                                 self.rng.random()))
        return cands[idx]

    def _on_bind(self, na):
        self._group_arr = np.array([self.info.node_group[n] for n in na.names],
                                   np.int64)

    def select_node_idx(self, task, mask, db):
        cand = np.flatnonzero(mask)
        if cand.size == 0:
            return None
        na = self._na
        scores = self.model.placement_scores(
            task.workflow, task.name, self._group_arr[cand],
            na.n_running[cand])
        if scores is None:
            return allocation.least_loaded_idx(na, cand, self.rng)
        loads = allocation.node_loads(na, cand)
        ties = self.rng.random(cand.size)
        order = np.lexsort((ties, loads, scores))
        return int(cand[order[0]])


def make_scheduler(name: str, specs, seed: int = 0, device=None,
                   **kw) -> Scheduler:
    """Scheduler ``name`` over ``specs``.  ``device`` (default CUDA, see
    ``repro_torch.device``) is checked for every name and used by the
    profiled ones (sjfn, tarema, weighted-tarema, predictive)."""
    device = resolve_device(device)
    names = [s.name for s in specs]
    if name == "roundrobin":
        return RoundRobinScheduler(names, seed)
    if name == "fair":
        return FairScheduler(seed)
    if name == "fillnodes":
        return FillNodesScheduler(names, seed)
    if name == "sjfn":
        return SJFNScheduler(specs, seed, device=device, **kw)
    if name == "tarema":
        return TaremaScheduler(specs, seed, device=device, **kw)
    if name == "weighted-tarema":
        return WeightedTaremaScheduler(specs, seed, device=device, **kw)
    if name == "predictive":
        return PredictiveScheduler(specs, seed, device=device, **kw)
    raise ValueError(name)


SCHEDULERS = ("roundrobin", "fair", "fillnodes", "sjfn", "tarema")
BASELINES = ("roundrobin", "fair", "fillnodes")
# the paper's five plus the multi-tenant extension (tenancy_bench sweeps these)
TENANT_SCHEDULERS = SCHEDULERS + ("weighted-tarema",)
# everything, including the prediction-gated scheduler — test sweeps use
# this; benches keep the tuples above because "predictive" additionally
# needs EngineConfig.prediction armed
ALL_SCHEDULERS = TENANT_SCHEDULERS + ("predictive",)
