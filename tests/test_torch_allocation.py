"""The port's phase-3 scoring against the reference's, on the CPU.

Scores are sums of absolute differences of small integers, so they must be
equal — not close — and float32, as ``np.asarray`` of the reference's jnp
result is; priority orders must then be identical.
"""
import itertools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import allocation as jal
from repro.core import labeling as jlab
from repro.core.clustering import choose_k
from repro.core.profiler import profile_cluster_synthetic
from repro.workflow.cluster import CLUSTERS
from repro_torch.core import allocation as tal
from repro_torch.core import labeling as tlab
from repro_torch.core.profiler import profile_cluster_synthetic as tprofiles
from repro_torch.workflow.cluster import CLUSTERS as TCLUSTERS

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=sorted(CLUSTERS))
def infos(request):
    """(reference GroupInfo, port GroupInfo) over the reference grouping."""
    name = request.param
    jp = profile_cluster_synthetic(CLUSTERS[name](), 0)
    labels = choose_k(np.stack([p.vector() for p in jp]), k_max=6)["labels"]
    tp = tprofiles(TCLUSTERS[name](), 0)
    return jlab.build_group_info(jp, labels), tlab.build_group_info(tp, labels)


def test_score_matrix_equal_and_float32():
    rng = np.random.default_rng(0)
    g = rng.integers(1, 7, (6, 3))
    t = rng.integers(1, 7, (50, 3))
    got = tal.score_matrix(g, t, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jal.score_matrix(g, t))
    np.testing.assert_array_equal(got.numpy(), want)


def test_label_vectors_scores_and_priorities_identical(infos):
    jinfo, tinfo = infos
    n = jinfo.n_groups
    for vec in itertools.product(range(1, n + 1), repeat=3):
        labels = dict(zip(("cpu", "mem", "io"), vec))
        got = tal.task_scores(tinfo, labels, device="cpu")
        want = jal.task_scores(jinfo, labels)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert tal.priority_groups(tinfo, labels, device="cpu") \
            == jal.priority_groups(jinfo, labels)
        for overuse in (0.0, 0.05, 0.4):
            assert tal.weighted_priority_groups(
                tinfo, labels, overuse, 1.5, device="cpu") \
                == jal.weighted_priority_groups(jinfo, labels, overuse, 1.5)


def test_score_matrix_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tal.score_matrix(np.ones((2, 3)), np.ones((1, 3)))
