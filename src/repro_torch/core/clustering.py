"""k-means++ clustering with silhouette-based model selection (paper §IV-B).

PyTorch counterpart of ``repro.core.clustering``.  The tensor's device
picks the k-means route: on the card every Lloyd iteration is one launch
of the fused ``kmeans_lloyd_step`` kernel, and the k-means++ D² distances
and the final inertia come from the ``kmeans_assign`` kernel; on the CPU
the same calls take their plain versions (segment sums, no (n, k)
one-hot).  ``silhouette_blocked`` streams row blocks so the dense (n, n)
distance matrix never exists, and ``choose_k`` scores large inputs on a
deterministic subsample through it.

Random draws come from CPU ``torch.Generator``s seeded per (seed, k,
restart), so a CPU run and a card run of this module make the same
choices.  They are not ``jax.random``'s draws: against the reference the
groupings agree up to renumbering, and given the same initial centres
(``lloyd``) the labels agree exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.kmeans import kmeans_assign, kmeans_lloyd_step


def standardize(X, mode: str = "relative") -> torch.Tensor:
    """Feature scaling before clustering.

    mode="relative" (default): (x - mean)/mean — features are compared by
    *relative* spread, so benchmark noise on features that are identical
    across the cluster (e.g. I/O on the paper's shared-PD clusters, Table IV)
    stays near zero instead of being amplified to unit variance the way a
    z-score would.  mode="zscore" for well-separated features.
    """
    X = torch.as_tensor(X, dtype=torch.float32)
    mu = X.mean(0)
    if mode == "relative":
        return (X - mu) / torch.where(mu.abs() > 1e-12, mu, 1.0)
    sd = X.std(0, correction=0)
    ok = sd > 1e-12
    return torch.where(ok, (X - mu) / torch.where(ok, sd, 1.0), 0.0)


def _pairwise_sq(X, C):
    x2 = (X * X).sum(1)[:, None]
    c2 = (C * C).sum(1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * (X @ C.T), min=0.0)


def _generator(*key: int) -> torch.Generator:
    """CPU generator seeded from non-negative ints, well mixed."""
    seed = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _init_centres(X, k: int, generator: torch.Generator):
    """k-means++: the first centre uniformly, each next one with
    probability proportional to max(D², 1e-30), the distribution of the
    reference's ``categorical(log(max(d2min, 1e-30)))``.  The uniforms
    come from ``generator`` on the CPU; the index is picked by inverse CDF
    on X's device, so the loop never waits for the device."""
    n, f = X.shape
    u = torch.rand(k, generator=generator, dtype=torch.float64)
    C = X.new_zeros((k, f))
    C[0] = X[min(int(u[0] * n), n - 1)]
    targets = u[1:].to(X.device)
    for m in range(1, k):
        _, d2min = kmeans_assign(X, C[:m])
        cdf = torch.cumsum(torch.clamp(d2min, min=1e-30).double(), 0)
        idx = torch.searchsorted(cdf, (targets[m - 1] * cdf[-1]).reshape(1),
                                 right=True).clamp_(max=n - 1)
        C[m:m + 1] = X.index_select(0, idx)
    return C


def lloyd(X, C0, iters: int = 32):
    """Lloyd iterations from initial centres C0 (k, f).

    Returns (labels (n,) int32, centers (k, f), inertia scalar tensor).
    ``labels`` is the last iteration's assignment against its pre-update
    centres, as in the reference; an empty cluster keeps its old centre;
    the inertia is taken against the final centres, clamped at 0."""
    C = C0.contiguous()
    labels = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    for _ in range(iters):
        labels, _, sums, counts = kmeans_lloyd_step(X, C)
        C = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1.0)[:, None], C)
    _, d2 = kmeans_assign(X, C)
    return labels, C, torch.clamp(d2, min=0.0).sum()


def kmeans_pp(X, k: int, generator: torch.Generator, iters: int = 32):
    """Returns (labels (n,) int32, centers (k, f), inertia scalar tensor)."""
    return lloyd(X, _init_centres(X, k, generator), iters)


def _silhouette_rows(d, lb, onehot, counts):
    """Silhouette of the rows of d (rows, n): point-to-point distances of
    points with labels lb to all n points.  Singletons get s=0."""
    k = onehot.shape[1]
    sums = d @ onehot                                       # (rows, k)
    own = counts[lb]
    a = torch.where(own > 1,
                    sums[torch.arange(d.shape[0], device=d.device), lb]
                    / torch.clamp(own - 1, min=1.0), 0.0)
    other = sums / torch.clamp(counts[None, :], min=1.0)
    ks = torch.arange(k, device=d.device)
    other = torch.where((ks[None, :] == lb[:, None]) | (counts[None, :] == 0),
                        torch.inf, other)
    b = other.min(1).values
    return torch.where(own > 1,
                       (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30),
                       0.0)


def silhouette(X, labels, k: int):
    """Mean silhouette coefficient.  Singleton clusters get s=0 (Rousseeuw)."""
    lb = labels.long()
    onehot = torch.nn.functional.one_hot(lb, k).to(X.dtype)   # (n, k)
    d = torch.sqrt(_pairwise_sq(X, X))                          # (n, n)
    return _silhouette_rows(d, lb, onehot, onehot.sum(0)).mean()


def silhouette_blocked(X, labels, k: int, block: int = 1024):
    """Mean silhouette without ever forming the (n, n) distance matrix.

    Streams row blocks: peak memory is (block, n) per step.  Same formula
    as ``silhouette`` (singletons get s=0), so results agree to float
    tolerance; use this above a few thousand points.
    """
    n = X.shape[0]
    lb = labels.long()
    onehot = torch.nn.functional.one_hot(lb, k).to(X.dtype)   # k is tiny
    counts = onehot.sum(0)
    total = X.new_zeros(())
    for s0 in range(0, n, block):
        d = torch.sqrt(_pairwise_sq(X[s0:s0 + block], X))
        total = total + _silhouette_rows(d, lb[s0:s0 + block], onehot,
                                         counts).sum()
    return total / n


def choose_k(X, k_max: int = 6, seed: int = 0, restarts: int = 4,
             silhouette_sample: int = 4096, silhouette_block: int = 1024,
             device=None):
    """Sweep k in [2, k_max], pick max silhouette (paper's control function).
    Returns dict(k, labels (np int32), centers (np float32), silhouette,
    per_k scores).

    Inputs of at most ``silhouette_sample`` points are scored densely.
    Above that, scores come from a deterministic subsample evaluated
    through ``silhouette_blocked``, so a 10^5-profile sweep completes
    without an (n, n) — or even (sample, sample) — distance matrix.
    ``seed`` (a non-negative int) fixes every random draw; ``device``
    defaults to the CUDA device (see ``repro_torch.device``).
    """
    dev = resolve_device(device)
    X = standardize(torch.as_tensor(np.asarray(X), dtype=torch.float32)
                    .to(dev))
    n = X.shape[0]
    if n < 3:
        # degenerate profile sets (the k sweep needs 2 <= k <= n-1): a
        # single node is its own group; two nodes get one group each —
        # silhouette is undefined either way, reported as 0.0
        labels = np.arange(n, dtype=np.int32)
        return {"k": max(n, 1), "labels": labels,
                "centers": X.cpu().numpy().astype(np.float64),
                "silhouette": 0.0, "per_k": {}}
    sample_idx = None
    if n > silhouette_sample:
        perm = torch.randperm(n, generator=_generator(seed, 0x5117))
        sample_idx = perm[:silhouette_sample].to(dev)
    best = None
    per_k = {}
    for k in range(2, min(k_max, n - 1) + 1):
        best_k = None
        for r in range(restarts):
            labels, C, inertia = kmeans_pp(X, k, _generator(seed, k, r))
            inertia = float(inertia)
            if best_k is None or inertia < best_k[2]:
                best_k = (labels, C, inertia)
        labels, C, _ = best_k
        if sample_idx is None:
            score = float(silhouette(X, labels, k))
        else:
            score = float(silhouette_blocked(
                X[sample_idx], labels[sample_idx], k, block=silhouette_block))
        per_k[k] = score
        if best is None or score > best["silhouette"]:
            best = {"k": k, "labels": labels.cpu().numpy().astype(np.int32),
                    "centers": C.cpu().numpy().astype(np.float32),
                    "silhouette": score}
    best["per_k"] = per_k
    return best
