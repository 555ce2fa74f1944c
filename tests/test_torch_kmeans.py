"""The port's k-means kernels against the reference.

On the CPU the wrappers take their plain PyTorch versions; these are held
against ``repro.kernels.ref`` and against the reference's Pallas kernels
in interpret mode, on the same numpy inputs.  Tolerances: labels and
counts exact; squared distances atol 1e-3 (float32, another summation
order); sums atol 1e-3 and rtol 1e-5.  The CUDA kernels themselves are
held against the plain versions in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.kernels import kmeans as pallas_km  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import kmeans as km  # noqa: E402

torch.set_num_threads(1)


def _inputs(N, f, k, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, f)).astype(np.float32),
            rng.standard_normal((k, f)).astype(np.float32))


def _check_assign(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=1e-3)


def _check_lloyd(got, want, N):
    _check_assign(got, want)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               atol=1e-3, rtol=1e-5)
    assert float(np.sum(np.asarray(got[3]))) == N


@pytest.mark.parametrize("N,f,k", [(1024, 8, 4), (2048, 16, 8), (512, 6, 3)])
def test_kmeans_assign_plain_matches_reference(N, f, k):
    x, c = _inputs(N, f, k)
    got = km.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    _check_assign(got, ref.kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    _check_assign(got, ops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                         interpret=True))


@pytest.mark.parametrize("N,f,k", [(1024, 8, 4), (2048, 16, 8), (512, 6, 3),
                                   (4096, 6, 6)])
def test_kmeans_lloyd_step_plain_matches_reference(N, f, k):
    x, c = _inputs(N, f, k)
    got = km.kmeans_lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    assert [t.dtype for t in got] == [torch.int32] + [torch.float32] * 3
    _check_lloyd(got, ref.kmeans_lloyd_step(jnp.asarray(x), jnp.asarray(c)),
                 N)
    _check_lloyd(got, ops.kmeans_lloyd_step(jnp.asarray(x), jnp.asarray(c),
                                            interpret=True), N)


def test_kmeans_lloyd_step_plain_empty_cluster():
    """One centre far from every point: its sums and count are zero, as
    in the reference's empty-cluster case (Pallas in interpret mode)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.0, (64, 4)).astype(np.float32)
    c = np.concatenate([rng.normal(0.0, 1.0, (3, 4)),
                        np.full((1, 4), 1e4)]).astype(np.float32)
    got = km.kmeans_lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    _check_lloyd(got, ref.kmeans_lloyd_step(jnp.asarray(x), jnp.asarray(c)),
                 64)
    _check_lloyd(got, pallas_km.kmeans_lloyd_step(
        jnp.asarray(x), jnp.asarray(c), block_n=16, interpret=True), 64)
    assert float(got[3][3]) == 0.0
    np.testing.assert_array_equal(got[2][3].numpy(), np.zeros(4))


@pytest.mark.parametrize("N,f,k", [(1025, 6, 3), (65, 3, 2), (1, 5, 4)])
def test_kmeans_ragged_n_matches_oracle(N, f, k):
    """N that no block size divides: the TPU kernel refuses it, the port
    takes it, so the port is held against the oracle only."""
    x, c = _inputs(N, f, k, seed=N)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    _check_assign(km.kmeans_assign(xt, ct),
                  ref.kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    _check_lloyd(km.kmeans_lloyd_step(xt, ct),
                 ref.kmeans_lloyd_step(jnp.asarray(x), jnp.asarray(c)), N)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, c = _inputs(256, 4, 3)
    before = (km.kmeans_assign.launches, km.kmeans_lloyd_step.launches)
    km.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    km.kmeans_lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    assert (km.kmeans_assign.launches, km.kmeans_lloyd_step.launches) \
        == before


def test_other_devices_raise():
    x = torch.empty(8, 3, device="meta")
    c = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError, match="no k-means route"):
        km.kmeans_assign(x, c)
    with pytest.raises(ValueError, match="no k-means route"):
        km.kmeans_lloyd_step(x, c)
