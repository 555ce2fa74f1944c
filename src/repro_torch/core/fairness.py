"""Fairness / SLO accounting for multi-tenant workflow streams (§V-F).

The paper's second headline claim is that Tarema provides *fair* cluster
usage when several long-running workflows share restricted resources.  This
module turns an engine run's assignment log into the numbers that claim is
judged by:

  * **Jain's fairness index** over any per-tenant quantity (service shares,
    inverse slowdowns): ``(sum x)^2 / (n * sum x^2)`` — 1.0 is perfectly
    fair, ``1/n`` is a single tenant starving everyone else.
  * **Per-tenant slowdown** vs. an isolated-run baseline: response time of
    each workflow run (arrival -> last task end) in the shared cluster
    divided by the same run executed alone, plus SLO attainment (the
    fraction of runs whose slowdown stays under a threshold).
  * **Per-group share-of-allocations**: how each tenant's core-seconds are
    spread over the profiled node groups / machine tiers — the paper's
    restricted-resources protocol (fig. 8) is about exactly this split.

Everything is vectorized: the log is converted once into numpy arrays and
aggregated with ``np.bincount`` over factorized (tenant, group) codes, so a
fleet-scale run with 10^5 assignments costs a few array passes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np


class AssignmentRecord(NamedTuple):
    """One task placement *attempt*, as appended by ``Engine._finish`` and
    ``Engine._kill``.

    Richer than the seed's ``(task, node, start, end)`` tuple (which is kept
    unchanged for bit-for-bit equivalence with ``engine_ref``): carries the
    tenant tag and enough identity that all fairness accounting is derivable
    from the log alone.

    ``completed`` is False for partial attempts — killed by a node failure,
    an OOM event (see ``repro_torch.core.sizing``), or speculative-pair
    resolution.  Those attempts consumed cores and memory for their whole
    run, so service accounting (Jain-over-core-seconds, group shares) MUST
    include them; ``Engine._kill`` formerly never logged them, silently
    undercounting tenants hit by failures.  ``outcome`` refines the flag:
    ``"done"``, ``"oom"`` (killed, will retry), ``"oom-fail"`` (retries
    exhausted, instance failed permanently), ``"node-failure"`` (requeued),
    ``"speculative-loser"``.  The fault subsystem
    (``repro_torch.workflow.faults``) adds ``"node-crash"``, ``"task-failure"``
    and ``"timeout"`` (killed, will retry after backoff), ``"fault-fail"``
    (retry budget exhausted, failed permanently) and ``"cancelled"``
    (zero-duration marker for a pending descendant of a permanent failure —
    no node, no service, but the lost subtree stays attributable).
    ``mem_gb`` is the request the attempt ran
    under (the *sized* request when ``EngineConfig.sizing`` is on) and
    ``used_mem_gb`` the sampled peak it reached, so allocated-minus-used
    wastage integrates directly off the log (``sizing.wastage_report``).
    """
    instance: str
    task: str
    workflow: str
    run_id: int
    tenant: str
    node: str
    start: float
    end: float
    cores: int
    mem_gb: float
    submit_t: float
    completed: bool = True
    used_mem_gb: float = 0.0
    outcome: str = "done"


def jains_index(x) -> float:
    """Jain's fairness index of a non-negative vector; 1.0 == perfectly fair.

    Empty or all-zero input is vacuously fair (no tenant received anything
    *unequally*), so returns 1.0.
    """
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 1.0
    s2 = float(np.sum(x * x))
    if s2 <= 0.0:
        return 1.0
    s = float(np.sum(x))
    return s * s / (x.size * s2)


def _factorize(values: list) -> tuple[list, np.ndarray]:
    keys = sorted(set(values))
    idx = {k: i for i, k in enumerate(keys)}
    return keys, np.fromiter((idx[v] for v in values), np.int64,
                             count=len(values))


def core_seconds_by(records: list[AssignmentRecord],
                    node_group: Optional[dict] = None):
    """Aggregate allocated core-seconds per tenant (and per node group).

    Includes partial (killed/requeued/OOM'd) attempts: they held their
    reservation for their whole interval, and dropping them undercounts
    exactly the tenants that failures hit.

    Returns ``(tenants, groups, matrix)`` where ``matrix[t, g]`` is the
    core-seconds tenant ``t`` consumed on group ``g``.  ``node_group`` maps
    node name -> group key (profiling group index or machine tier); when
    omitted every node lands in a single ``"all"`` group.
    """
    # cancelled descendants never held a node (node == "", zero duration):
    # they carry no service, and indexing node_group with "" would blow up
    records = [r for r in records if r.node]
    if not records:
        return [], [], np.zeros((0, 0), np.float64)
    tenants, t_code = _factorize([r.tenant for r in records])
    if node_group is None:
        groups, g_code = ["all"], np.zeros(len(records), np.int64)
    else:
        groups, g_code = _factorize([node_group[r.node] for r in records])
    cs = (np.array([r.end for r in records], np.float64)
          - np.array([r.start for r in records], np.float64)) \
        * np.array([r.cores for r in records], np.float64)
    flat = np.bincount(t_code * len(groups) + g_code, weights=cs,
                       minlength=len(tenants) * len(groups))
    return tenants, groups, flat.reshape(len(tenants), len(groups))


def _shares_from(tenants: list, groups: list, m: np.ndarray) -> dict:
    """Column-normalize a (tenant x group) core-second matrix into
    ``{tenant: {group: share}}`` (single formula source for the public
    ``group_shares`` and ``fairness_report``)."""
    if not m.size:
        return {}
    totals = m.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        share = np.where(totals > 0, m / np.where(totals > 0, totals, 1.0), 0.0)
    return {t: {g: float(share[i, j]) for j, g in enumerate(groups)}
            for i, t in enumerate(tenants)}


def group_shares(records: list[AssignmentRecord],
                 node_group: dict) -> dict:
    """Per-tenant share of each node group's allocated core-seconds.

    ``out[tenant][group]`` is the fraction of the group's total allocated
    core-seconds that went to the tenant (columns sum to 1 over tenants for
    every group that served any work).
    """
    return _shares_from(*core_seconds_by(records, node_group))


def response_times(records: list[AssignmentRecord]) -> dict:
    """Response time of every workflow run: (tenant, workflow, run_id) ->
    (arrival, completion, response).  Arrival is the run's submit time,
    completion the last task end.  Killed partial attempts
    (``completed=False``) count toward *service*, not completion, so they
    are skipped here — and a run containing a permanently-failed task
    (``outcome="oom-fail"`` or ``"fault-fail"``: its downstream was
    cancelled) never completed at all, so it is excluded entirely rather
    than scored as a fast "success" at its last surviving task."""
    failed = {(r.tenant, r.workflow, r.run_id) for r in records
              if r.outcome in ("oom-fail", "fault-fail")}
    out: dict = {}
    for r in records:
        if not r.completed or (failed and
                               (r.tenant, r.workflow, r.run_id) in failed):
            continue
        key = (r.tenant, r.workflow, r.run_id)
        hit = out.get(key)
        if hit is None:
            out[key] = [r.submit_t, r.end]
        else:
            if r.submit_t < hit[0]:
                hit[0] = r.submit_t
            if r.end > hit[1]:
                hit[1] = r.end
    return {k: (a, c, c - a) for k, (a, c) in out.items()}


def _run_ratios(rs: dict, ri: dict) -> list[tuple[str, float]]:
    """(tenant, shared/isolated response ratio) per run present in both
    response-time maps; runs missing from either (e.g. still pending) are
    skipped."""
    return [(key[0], resp / ri[key][2])
            for key, (_, _, resp) in rs.items()
            if key in ri and ri[key][2] > 0]


def _mean_by_tenant(ratios: list[tuple[str, float]]) -> dict:
    per_tenant: dict = {}
    for t, r in ratios:
        per_tenant.setdefault(t, []).append(r)
    return {t: float(np.mean(v)) for t, v in sorted(per_tenant.items())}


def tenant_slowdowns(shared: list[AssignmentRecord],
                     isolated: list[AssignmentRecord]) -> dict:
    """Per-tenant mean slowdown: response in the shared cluster over the
    response of the identical run executed in isolation."""
    return _mean_by_tenant(_run_ratios(response_times(shared),
                                       response_times(isolated)))


@dataclasses.dataclass
class FairnessReport:
    """Everything `tenancy_bench` / `fig8` report per scheduler."""
    tenants: list
    core_seconds: dict                    # tenant -> total core-seconds
    jain_core_seconds: float              # fairness of raw service
    slowdown: dict                        # tenant -> mean slowdown vs isolated
    jain_slowdown: Optional[float]        # fairness of normalized progress
    slo_attainment: Optional[float]       # fraction of runs under slo_factor
    group_share: dict                     # tenant -> {group: share}

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def fairness_report(shared: list[AssignmentRecord],
                    isolated: Optional[list[AssignmentRecord]] = None,
                    node_group: Optional[dict] = None,
                    slo_factor: float = 2.0) -> FairnessReport:
    """Build the full report from a shared-cluster assignment log.

    ``isolated`` supplies the per-run baseline (same streams, each tenant
    alone); without it — or when no run exists in both logs — the slowdown
    map is empty and ``jain_slowdown``/``slo_attainment`` are None
    (unmeasured, never "perfectly fair").  Jain-over-slowdown uses inverse
    slowdowns (normalized progress), so a starved tenant *lowers* the
    index.  One pass each over the logs: the (tenant x group) core-second
    matrix and the response-time maps are computed once and reused.
    """
    tenants, groups, m = core_seconds_by(shared, node_group)
    totals = {t: float(v) for t, v in zip(tenants, m.sum(axis=1))}
    share = _shares_from(tenants, groups, m) if node_group is not None else {}
    slowdown: dict = {}
    slo = None
    if isolated is not None:
        ratios = _run_ratios(response_times(shared), response_times(isolated))
        slowdown = _mean_by_tenant(ratios)
        if ratios:
            slo = float(np.mean([r <= slo_factor for _, r in ratios]))
    progress = [1.0 / s for s in slowdown.values() if s > 0]
    return FairnessReport(
        tenants=tenants,
        core_seconds=totals,
        jain_core_seconds=jains_index(list(totals.values())),
        slowdown=slowdown,
        jain_slowdown=jains_index(progress) if progress else None,
        slo_attainment=slo,
        group_share=share,
    )
