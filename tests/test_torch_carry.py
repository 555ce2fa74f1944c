"""Carrying the reference's state into the port: monitoring history, node
specs, profiles and the grouping, as plain data."""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import labeling as jlab
from repro.core.clustering import choose_k
from repro.core.monitor import TASK_FEATURES, TraceDB
from repro.core.profiler import profile_cluster_synthetic
from repro.core.scheduler import make_scheduler
from repro.workflow.cluster import CLUSTERS
from repro.workflow.engine import Engine, EngineConfig
from repro.workflow.nfcore import WORKFLOWS
from repro_torch import carry
from repro_torch.core import labeling as tlab
from repro_torch.core.profiler import NodeProfile, NodeSpec
from repro_torch.workflow.cluster import CLUSTERS as TCLUSTERS


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_history_round_trip_gives_equal_labels(tmp_path, cluster):
    specs = CLUSTERS[cluster]()
    db = TraceDB()
    for run, wf in enumerate(("viralrecon", "eager")):
        eng = Engine(specs, make_scheduler("fair", specs, seed=run), db,
                     EngineConfig(seed=run))
        eng.submit(WORKFLOWS[wf](), run_id=run, seed=0)
        eng.run()
    path = tmp_path / "traces.json"
    db.save(str(path))
    tdb = carry.tracedb_from_records(json.loads(path.read_text()))
    assert [dataclasses.asdict(r) for r in tdb.records] \
        == [dataclasses.asdict(r) for r in db.records]
    assert tdb.version == db.version

    jprofiles = profile_cluster_synthetic(specs, 0)
    g = choose_k(np.stack([p.vector() for p in jprofiles]), k_max=6)
    grouping = carry.grouping_from_arrays(g["k"], g["labels"], g["centers"],
                                          g["silhouette"])
    tprofiles = carry.profiles_from_dicts(
        [dataclasses.asdict(p) for p in jprofiles])
    assert all(isinstance(p, NodeProfile) for p in tprofiles)
    jinfo = jlab.build_group_info(jprofiles, g["labels"])
    tinfo = tlab.build_group_info(tprofiles, grouping["labels"])
    assert tinfo.node_labels == jinfo.node_labels
    labelled = 0
    for wf in ("viralrecon", "eager"):
        for task in sorted({r.task_name for r in db.records
                            if r.workflow == wf}):
            want = jlab.label_task(db, jinfo, wf, task)
            assert tlab.label_task(tdb, tinfo, wf, task) == want
            labelled += want is not None
            for f in TASK_FEATURES:
                assert tdb.mean_usage(wf, task, f) == db.mean_usage(wf, task, f)
    assert labelled > 0


def test_specs_round_trip():
    for name, make in CLUSTERS.items():
        rows = [dataclasses.asdict(s) for s in make()]
        specs = carry.specs_from_dicts(rows)
        assert all(isinstance(s, NodeSpec) for s in specs)
        assert specs == TCLUSTERS[name]()


def test_grouping_from_arrays_format():
    g = carry.grouping_from_arrays(2, [0, 1, 1], np.zeros((2, 6), np.float32),
                                   0.5)
    assert g["k"] == 2 and g["silhouette"] == 0.5 and g["per_k"] == {}
    assert g["labels"].dtype == np.int32
    np.testing.assert_array_equal(g["labels"], [0, 1, 1])
    assert g["centers"].dtype == np.float32 and g["centers"].shape == (2, 6)
