"""Workflow DAG model (paper §II): abstract tasks fan out into data-parallel
instances; edges are finish-before-start dependencies; tasks communicate via
files (modelled as I/O work on the shared volume).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.seeding import stable_seed  # noqa: F401  (re-exported)


@dataclasses.dataclass
class AbstractTask:
    name: str
    n_instances: int
    work: dict                       # {"cpu": events, "mem": MiB, "io": IOPS-s}
    peak_mem_gb: float               # monitored RSS
    deps: tuple = ()                 # names of abstract predecessor tasks
    req_cores: int = 2               # paper: all tasks 2 CPUs / 5 GB
    req_mem_gb: float = 5.0


@dataclasses.dataclass
class WorkflowSpec:
    name: str
    tasks: list                      # [AbstractTask]

    def task(self, name: str) -> AbstractTask:
        return next(t for t in self.tasks if t.name == name)


@dataclasses.dataclass
class TaskInstance:
    workflow: str
    run_id: int
    name: str                        # abstract task name (recurring key)
    instance: str                    # unique id e.g. "align[3]"
    work: dict
    peak_mem_gb: float
    req_cores: int
    req_mem_gb: float                # live request (rewritten under sizing)
    deps: tuple                      # instance ids
    # engine state.  "killed" covers node-failure victims that were never
    # re-run (speculative losers), OOM-failed instances that exhausted
    # their retries, and their cancelled downstream dependents.
    state: str = "pending"           # pending|ready|running|done|killed
    node: Optional[str] = None
    submit_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0
    remaining: Optional[dict] = None
    speculative_of: Optional[str] = None
    tenant: str = "default"          # multi-tenant stream tag (see tenancy.py)
    # online memory sizing (see repro_torch.core.sizing; engine-maintained)
    attempt: int = 0                 # OOM retries consumed so far
    base_req_mem_gb: Optional[float] = None   # spec request before sizing
    # fault-recovery budget (see repro_torch.workflow.faults; engine-maintained,
    # deliberately separate from the sizing `attempt` counter: an OOM
    # escalation is progress, a crash/timeout retry is not)
    fault_retries: int = 0           # fault-policy kills consumed so far


def instantiate(spec: WorkflowSpec, run_id: int, seed: int,
                input_scale: float = 1.0) -> list[TaskInstance]:
    """Expand a WorkflowSpec into task instances.  Per paper A3, repeated runs
    use different input data: per-run and per-instance lognormal work jitter.
    Dependencies are all-to-all between abstract task levels (fork/join via
    files), matching the Nextflow channel model.
    """
    rng = np.random.default_rng((stable_seed(spec.name), seed, run_id))
    run_scale = float(rng.lognormal(0.0, 0.05)) * input_scale
    instances: list[TaskInstance] = []
    by_task: dict[str, list[str]] = {}
    for t in spec.tasks:
        ids = []
        for i in range(t.n_instances):
            inst_scale = float(rng.lognormal(0.0, 0.35)) * run_scale
            work = {k: v * inst_scale for k, v in t.work.items()}
            iid = f"{t.name}[{i}]"
            # Nextflow channel semantics: equal-width stages chain per sample
            # (instance i depends only on parent i); width-1 children join
            # everything; otherwise samples are grouped i -> i % parent_width.
            deps = []
            for dep in t.deps:
                parents = by_task[dep]
                if t.n_instances == 1 or len(parents) == 1:
                    deps.extend(parents)
                elif len(parents) == t.n_instances:
                    deps.append(parents[i])
                elif len(parents) > t.n_instances:
                    deps.extend(parents[i::t.n_instances])
                else:
                    deps.append(parents[i % len(parents)])
            instances.append(TaskInstance(
                workflow=spec.name, run_id=run_id, name=t.name, instance=iid,
                work=work, peak_mem_gb=t.peak_mem_gb * min(inst_scale, 1.2),
                req_cores=t.req_cores, req_mem_gb=t.req_mem_gb,
                deps=tuple(deps)))
            ids.append(iid)
        by_task[t.name] = ids
    return instances
