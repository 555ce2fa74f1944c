"""The port's clustering against the reference's, on the CPU.

``jax.random`` draws cannot be reproduced in PyTorch, so randomized parts
are compared at their seams: given the reference's own k-means++ centres,
``lloyd`` gives the same labels exactly and the same centres and inertia
at rtol 1e-5 (float32, another summation order); end to end ``choose_k``
finds the same k and the same partition up to renumbering.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as jcl  # noqa: E402
from repro.core.profiler import profile_cluster_synthetic  # noqa: E402
from repro.workflow.cluster import cluster_555, cluster_5442  # noqa: E402
from chip_smoke import fleet_probe, same_partition  # noqa: E402
from repro_torch.core import clustering as tcl  # noqa: E402

torch.set_num_threads(1)


def _profiles(cluster):
    return np.stack([p.vector() for p in profile_cluster_synthetic(cluster(), 0)])


def _blobs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, f)) * 5.0
    return c[rng.integers(0, k, n)] + rng.standard_normal((n, f)) * 0.5


# z-scores of the I/O features divide x - mean (x ~ 482, one float32 ulp
# ~3e-5, and the two means may differ by one) by a sigma near 1
@pytest.mark.parametrize("mode,atol", [("relative", 1e-6), ("zscore", 1e-4)])
def test_standardize_matches_reference(mode, atol):
    X = _profiles(cluster_5442)
    got = tcl.standardize(X, mode).numpy()
    want = np.asarray(jcl.standardize(X, mode))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("case,k", [("555", 3), ("555", 6), ("5442", 4),
                                    ("blobs", 5), ("blobs", 8)])
def test_lloyd_from_reference_centres(case, k):
    """Same initial centres (the reference's k-means++ draw): identical
    labels, centres and inertia at rtol 1e-5."""
    raw = {"555": lambda: _profiles(cluster_555),
           "5442": lambda: _profiles(cluster_5442),
           "blobs": lambda: _blobs(600, 6, 5, seed=k)}[case]()
    Xs = np.array(jcl.standardize(raw))
    key = jax.random.key(k)
    _, C0, _ = jcl.kmeans_pp(jnp.asarray(Xs), k, key, iters=0)
    want_lab, want_C, want_inertia = jcl.kmeans_pp(jnp.asarray(Xs), k, key)
    lab, C, inertia = tcl.lloyd(torch.from_numpy(Xs),
                                torch.from_numpy(np.array(C0)), 32)
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(C.numpy(), np.asarray(want_C), rtol=1e-5,
                               atol=1e-7)
    # each distance ||x||^2 + ||c||^2 - 2 x.c carries a few float32 ulps
    # of ||x||^2 (~1e-7 at unit norms) as absolute error, which a small
    # inertia cannot absorb in rtol alone
    np.testing.assert_allclose(float(inertia), float(want_inertia),
                               rtol=1e-5, atol=1e-6)


def test_lloyd_empty_cluster_keeps_its_centre():
    X = torch.tensor([[0.0, 0.0], [0.1, 0.0], [10.0, 0.0]])
    C0 = torch.tensor([[0.0, 0.0], [10.0, 0.0], [50.0, 50.0]])
    lab, C, inertia = tcl.lloyd(X, C0, 3)
    np.testing.assert_array_equal(lab.numpy(), [0, 0, 1])
    np.testing.assert_array_equal(C[2].numpy(), [50.0, 50.0])
    np.testing.assert_allclose(float(inertia), 0.005, rtol=1e-5)


def test_lloyd_returns_pre_update_labels_and_final_inertia():
    """Labels are the last iteration's assignment against its pre-update
    centres (as the reference's scan returns them); the inertia is taken
    against the updated centres."""
    X = torch.tensor([[0.0, 0.0], [2.0, 0.0], [3.0, 0.0], [10.0, 0.0]])
    C0 = torch.tensor([[0.0, 0.0], [2.9, 0.0]])
    lab, C, inertia = tcl.lloyd(X, C0, 1)
    np.testing.assert_array_equal(lab.numpy(), [0, 1, 1, 1])
    np.testing.assert_allclose(C.numpy(), [[0.0, 0.0], [5.0, 0.0]])
    np.testing.assert_allclose(float(inertia), 0.0 + 4.0 + 4.0 + 25.0,
                               rtol=1e-6)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_silhouette_dense_blocked_and_reference_agree(k):
    X = np.array(jcl.standardize(_blobs(700, 4, k, seed=k)), np.float32)
    labels = np.random.default_rng(k).integers(0, k, 700).astype(np.int32)
    labels[:k] = np.arange(k)
    Xt, lt = torch.from_numpy(X), torch.from_numpy(labels)
    dense = float(tcl.silhouette(Xt, lt, k))
    blocked = float(tcl.silhouette_blocked(Xt, lt, k, block=128))
    want = float(jcl.silhouette(jnp.asarray(X), jnp.asarray(labels), k))
    assert abs(dense - blocked) <= 1e-5
    assert abs(dense - want) <= 1e-5


@pytest.mark.parametrize("cluster", [cluster_555, cluster_5442])
def test_choose_k_matches_reference_on_paper_clusters(cluster):
    X = _profiles(cluster)
    got = tcl.choose_k(X, device="cpu")
    want = jcl.choose_k(X)
    assert got["k"] == want["k"] == 3
    assert same_partition(got["labels"], want["labels"])
    assert got["labels"].dtype == np.int32
    assert got["centers"].dtype == np.float32
    assert got["centers"].shape == (3, X.shape[1])
    assert abs(got["silhouette"] - want["silhouette"]) < 1e-3


def test_choose_k_subsample_path_matches_reference():
    """8,192 fleet-probe profiles: above the 4,096-point sample, so both
    packages score on a subsample through the blocked silhouette."""
    X = fleet_probe(8192)
    got = tcl.choose_k(X, k_max=4, restarts=2, device="cpu")
    want = jcl.choose_k(X, k_max=4, restarts=2)
    assert got["k"] == want["k"] == 3
    assert same_partition(got["labels"], want["labels"])


def test_choose_k_is_deterministic_in_seed():
    X = _blobs(300, 3, 4, seed=3)
    a = tcl.choose_k(X, seed=5, device="cpu")
    b = tcl.choose_k(X, seed=5, device="cpu")
    np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(a["centers"], b["centers"])
    assert a["per_k"] == b["per_k"]


@pytest.mark.parametrize("n", [1, 2])
def test_choose_k_tiny_inputs_identical(n):
    X = _profiles(cluster_555)[:n]
    got, want = tcl.choose_k(X, device="cpu"), jcl.choose_k(X)
    assert got["k"] == want["k"] and got["per_k"] == want["per_k"] == {}
    assert got["silhouette"] == want["silhouette"] == 0.0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["labels"].dtype == want["labels"].dtype
    np.testing.assert_array_equal(got["centers"], want["centers"])
    assert got["centers"].dtype == want["centers"].dtype == np.float64


def test_choose_k_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcl.choose_k(_profiles(cluster_555))
