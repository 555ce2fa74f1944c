"""Engine runs placed by the port's schedulers against the reference's.

Both paper clusters x the five nf-core workflows x every scheduler: two
runs share one TraceDB, so the second run's Tarema places with labels.
Group numbering breaks ties in the priority order, so both scheduler
modules get the reference's grouping injected; with it, makespan,
assignments, the assignment and prediction logs (named tuples, compared
as dicts) and the monitoring records must be bit-for-bit equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import scheduler as jsched
from repro.core.clustering import choose_k
from repro.core.monitor import TraceDB as JTraceDB
from repro.core.prediction import PredictionConfig as JPredictionConfig
from repro.core.profiler import profile_cluster_synthetic
from repro.workflow import engine as jengine
from repro.workflow.cluster import CLUSTERS
from repro.workflow.nfcore import WORKFLOWS
from repro_torch.carry import grouping_from_arrays
from repro_torch.core import scheduler as tsched
from repro_torch.core.monitor import TraceDB as TTraceDB
from repro_torch.core.prediction import PredictionConfig as TPredictionConfig
from repro_torch.workflow import engine as tengine
from repro_torch.workflow.cluster import CLUSTERS as TCLUSTERS
from repro_torch.workflow.nfcore import WORKFLOWS as TWORKFLOWS

torch.set_num_threads(1)

_GROUPINGS: dict = {}


def _reference_grouping(cluster):
    if cluster not in _GROUPINGS:
        X = np.stack([p.vector() for p in
                      profile_cluster_synthetic(CLUSTERS[cluster](), 0)])
        _GROUPINGS[cluster] = choose_k(X, k_max=6)
    return _GROUPINGS[cluster]


def _runs(sched_mod, engine_mod, TraceDB, PredictionConfig, specs, workflow,
          sched_name, **kw):
    db = TraceDB()
    out = []
    for run in range(2):
        sched = sched_mod.make_scheduler(sched_name, specs, seed=run * 7 + 3,
                                         **kw)
        cfg = engine_mod.EngineConfig(
            seed=run, prediction=PredictionConfig()
            if sched_name == "predictive" else None)
        eng = engine_mod.Engine(specs, sched, db, cfg)
        eng.submit(workflow(), run_id=run, seed=11)
        res = eng.run()
        out.append((res["makespan"], res["assignments"],
                    [r._asdict() for r in eng.assignment_log],
                    [r._asdict() for r in eng.prediction_log]))
    out.append([dataclasses.asdict(r) for r in db.records])
    return out


@pytest.mark.parametrize("sched_name", jsched.ALL_SCHEDULERS)
@pytest.mark.parametrize("workflow", sorted(WORKFLOWS))
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_engine_runs_bit_for_bit(monkeypatch, cluster, workflow, sched_name):
    g = _reference_grouping(cluster)
    monkeypatch.setattr(jsched, "choose_k", lambda X, **kw: g)
    tg = grouping_from_arrays(g["k"], g["labels"], g["centers"],
                              g["silhouette"])
    monkeypatch.setattr(tsched, "choose_k", lambda X, **kw: tg)
    want = _runs(jsched, jengine, JTraceDB, JPredictionConfig,
                 CLUSTERS[cluster](), WORKFLOWS[workflow], sched_name)
    got = _runs(tsched, tengine, TTraceDB, TPredictionConfig,
                TCLUSTERS[cluster](), TWORKFLOWS[workflow], sched_name,
                device="cpu")
    assert got == want


def test_all_scheduler_names_build():
    specs = TCLUSTERS["5;5;5"]()
    assert tsched.ALL_SCHEDULERS == jsched.ALL_SCHEDULERS
    for name in tsched.ALL_SCHEDULERS:
        sched = tsched.make_scheduler(name, specs, device="cpu")
        assert sched.name == name


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_tarema_with_its_own_grouping(cluster):
    """No injection: the port groups with its own choose_k, finds the
    reference's partition, and a labelled Tarema run completes."""
    specs = TCLUSTERS[cluster]()
    db = TTraceDB()
    for run in range(2):
        sched = tsched.make_scheduler("tarema", specs, seed=run,
                                      device="cpu")
        eng = tengine.Engine(specs, sched, db,
                             tengine.EngineConfig(seed=run))
        eng.submit(TWORKFLOWS["viralrecon"](), run_id=run, seed=0)
        res = eng.run()
        assert len(res["assignments"]) == len(eng.all_tasks)
    want = _reference_grouping(cluster)["labels"]
    got = sched.grouping["labels"]
    assert sched.grouping["k"] == 3
    assert len(set(zip(got.tolist(), want.tolist()))) == 3


def test_make_scheduler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.make_scheduler("fair", TCLUSTERS["5;5;5"]())
