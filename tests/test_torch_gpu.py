"""The port's CUDA kernels on the card: against their plain PyTorch
versions, repeat launches bitwise equal, and the grouping and placement
path on the card against the same path on the CPU.  Inputs come from
``chip_smoke``'s generators, made with numpy from a seed.

Every test here needs a CUDA device; without one the ``cuda`` fixture
skips it.  On the card:  pytest -m gpu tests/test_torch_*.py
"""
import pytest
import torch

from chip_smoke import blobs, choose_k_launches, fleet_probe, same_partition
from repro_torch.core.clustering import choose_k
from repro_torch.core.monitor import TraceDB
from repro_torch.core.scheduler import make_scheduler
from repro_torch.kernels import kmeans as km
from repro_torch.workflow.cluster import cluster_555
from repro_torch.workflow.engine import Engine, EngineConfig
from repro_torch.workflow.nfcore import WORKFLOWS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    # the plain versions are the yardstick: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("N,f,k", [(100_000, 3, 3), (1000, 6, 5),
                                   (65_537, 128, 64), (1, 1, 1)])
def test_kernels_match_plain(cuda, N, f, k):
    """Labels and counts exact, distances (about 1, see ``blobs``) atol
    1e-3, sums atol 1e-3 and rtol 1e-5; two launches bitwise equal; one
    count per launch."""
    x_np, c_np = blobs(N, f, k, seed=N + k)
    x, c = torch.from_numpy(x_np).to(cuda), torch.from_numpy(c_np).to(cuda)
    before = (km.kmeans_assign.launches, km.kmeans_lloyd_step.launches)
    a1, a2 = km.kmeans_assign(x, c), km.kmeans_assign(x, c)
    l1, l2 = km.kmeans_lloyd_step(x, c), km.kmeans_lloyd_step(x, c)
    torch.cuda.synchronize()
    assert (km.kmeans_assign.launches, km.kmeans_lloyd_step.launches) \
        == (before[0] + 2, before[1] + 2)
    for u, v in zip(a1 + l1, a2 + l2):
        assert torch.equal(u, v)
    pa, pl = km.kmeans_assign_plain(x, c), km.kmeans_lloyd_step_plain(x, c)
    for got, want in ((a1, pa), (l1[:2], pl[:2])):
        assert torch.equal(got[0], want[0])
        assert float((got[1] - want[1]).abs().max()) <= 1e-3
    assert torch.equal(l1[3], pl[3]) and float(l1[3].sum()) == N
    assert torch.allclose(l1[2], pl[2], rtol=1e-5, atol=1e-3)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(16, 3, device=cuda)
    with pytest.raises(TypeError):
        km.kmeans_assign(x.double(), torch.zeros(2, 3, device=cuda).double())
    with pytest.raises(ValueError):
        km.kmeans_assign(x, torch.zeros(65, 3, device=cuda))
    with pytest.raises(ValueError):
        km.kmeans_lloyd_step(x.T, torch.zeros(2, 16, device=cuda))
    with pytest.raises(ValueError):
        km.kmeans_assign(x, torch.zeros(2, 3))


def test_choose_k_card_matches_cpu(cuda):
    X = fleet_probe(100_000)
    before = (km.kmeans_assign.launches, km.kmeans_lloyd_step.launches)
    got = choose_k(X, k_max=4, restarts=2, device=cuda)
    want = choose_k_launches(100_000, k_max=4, restarts=2)
    assert km.kmeans_assign.launches - before[0] == want["kmeans_assign"]
    assert km.kmeans_lloyd_step.launches - before[1] \
        == want["kmeans_lloyd_step"]
    want = choose_k(X, k_max=4, restarts=2, device="cpu")
    assert got["k"] == want["k"] == 3
    assert same_partition(got["labels"], want["labels"])


def test_tarema_places_as_on_the_cpu(cuda):
    out = {}
    for where in (cuda, "cpu"):
        specs, db, trace = cluster_555(), TraceDB(), []
        for run in range(2):
            sched = make_scheduler("tarema", specs, seed=run, device=where)
            eng = Engine(specs, sched, db, EngineConfig(seed=run))
            eng.submit(WORKFLOWS["viralrecon"](), run_id=run, seed=0)
            res = eng.run()
            trace.append((res["makespan"], res["assignments"]))
        out[str(where)] = trace
    assert out["cuda"] == out["cpu"]
