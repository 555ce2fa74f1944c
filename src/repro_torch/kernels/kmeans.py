"""k-means kernels: nearest-centre assignment and one fused Lloyd step.

Counterparts of ``repro.kernels.kmeans`` (TPU Pallas kernels).  The CUDA
kernels live in ``csrc/kmeans.cu`` (design and bound noted there); each
wrapper here checks its inputs, allocates outputs and scratch, launches on
the current stream and counts its launches in ``<wrapper>.launches``.

The tensor's device decides the route: a CPU tensor takes the plain
PyTorch version (``*_plain``, the math of ``repro.kernels.ref``), a CUDA
tensor takes the kernel or raises.  The plain versions also run on the
card, where ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kmeans_library

MAX_K = 64       # centres staged in shared memory: k * f floats <= 32 KB
MAX_F = 128


def kmeans_assign_plain(x: torch.Tensor, c: torch.Tensor):
    """x (N, f), c (k, f) -> (labels (N,) int32, sq-dists (N,) float32):
    first-index argmin and min of ||x||^2 + ||c||^2 - 2 x.c."""
    xf, cf = x.float(), c.float()
    d = ((xf * xf).sum(1)[:, None] + (cf * cf).sum(1)[None, :]
         - 2.0 * (xf @ cf.T))
    return d.argmin(1).to(torch.int32), d.min(1).values


def kmeans_lloyd_step_plain(x: torch.Tensor, c: torch.Tensor):
    """Assignment plus per-cluster sums (k, f) and counts (k,), float32:
    the one-hot contraction of the reference as a segment sum.  The sums
    accumulate in float64: on the card ``index_add_`` adds in the order
    its atomics land, which in float32 drifts past 1e-5 relative at 10^5
    points, so the float64 sum rounded once is the steadier yardstick."""
    labels, dists = kmeans_assign_plain(x, c)
    k, f = c.shape
    idx = labels.long()
    sums = torch.zeros(k, f, dtype=torch.float64, device=x.device)
    sums.index_add_(0, idx, x.double())
    counts = torch.bincount(idx, minlength=k).to(torch.float32)
    return labels, dists, sums.float(), counts


def _check(x: torch.Tensor, c: torch.Tensor) -> tuple[int, int, int]:
    """Shapes the kernels take; raises on anything else."""
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"need x (N, f) and c (k, f); got {tuple(x.shape)} "
                         f"and {tuple(c.shape)}")
    n, f = x.shape
    k = c.shape[0]
    if x.device != c.device:
        raise ValueError(f"x on {x.device} but c on {c.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32; got {x.dtype} and "
                        f"{c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous x and c")
    if not (1 <= k <= MAX_K and 1 <= f <= MAX_F):
        raise ValueError(f"the CUDA kernels take 1 <= k <= {MAX_K} and "
                         f"1 <= f <= {MAX_F}; got k={k}, f={f}")
    if not 1 <= n * f < 2 ** 31:
        raise ValueError(f"the CUDA kernels take 1 <= N * f < 2^31; got "
                         f"N={n}, f={f}")
    return n, k, f


def _route(x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no k-means route for device {x.device}")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = kmeans_library().kmeans_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def kmeans_assign(x: torch.Tensor, c: torch.Tensor):
    """x (N, f), c (k, f) float32 -> (labels (N,) int32, sq-dists (N,)
    float32), unclamped: the nearest centre of each point."""
    if not _route(x):
        return kmeans_assign_plain(x, c)
    n, k, f = _check(x, c)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    dists = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = kmeans_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(lib.kmeans_assign(x.data_ptr(), c.data_ptr(), n, k, f,
                                    labels.data_ptr(), dists.data_ptr(),
                                    stream), "kmeans_assign")
    kmeans_assign.launches += 1
    return labels, dists


def kmeans_lloyd_step(x: torch.Tensor, c: torch.Tensor):
    """One fused Lloyd step.  x (N, f), c (k, f) float32 -> (labels (N,)
    int32, sq-dists (N,) float32, sums (k, f) float32, counts (k,)
    float32): everything ``c' = sums / counts`` needs, from one pass."""
    if not _route(x):
        return kmeans_lloyd_step_plain(x, c)
    n, k, f = _check(x, c)
    lib = kmeans_library()
    n_blocks = -(-n // lib.kmeans_tile())
    dev = x.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    dists = torch.empty(n, dtype=torch.float32, device=dev)
    partial = torch.empty(n_blocks, k, f + 1, dtype=torch.float32, device=dev)
    sums = torch.empty(k, f, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.kmeans_lloyd_step(
            x.data_ptr(), c.data_ptr(), n, k, f, labels.data_ptr(),
            dists.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), stream), "kmeans_lloyd_step")
    kmeans_lloyd_step.launches += 1
    return labels, dists, sums, counts


kmeans_assign.launches = 0
kmeans_lloyd_step.launches = 0
