"""Phase 1.1 — cluster profiling (paper §IV-B / §V-A-a).

Two backends:

* ``profile_node_synthetic``: derives benchmark observations from a ground-
  truth ``NodeSpec`` plus seeded measurement noise, reproducing the ranges of
  paper Table IV for the simulated GCP clusters.
* ``profile_local``: real microbenchmarks of the *current* host:
  sysbench-CPU -> f32 matmul FLOP/s; sysbench-memory -> memory-stream
  bandwidth; fio -> tmpfile I/O.  In this package the first two run in
  numpy on the host; moving them to the card is a later slice of the port.

Feature vector order is FEATURES; clustering/labeling consume it positionally.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch.core.seeding import stable_seed

FEATURES = ("cpu", "mem", "io_seq_read", "io_seq_write", "io_rand_read",
            "io_rand_write")

# capacity feature used for the percentile weighting of each label feature
CAPACITY_FOR_FEATURE = {"cpu": "cores", "mem": "mem_gb", "io": "nodes"}


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Ground truth for a (simulated) node; benchmark scores derive from it."""
    name: str
    machine: str                 # e.g. "n1", "c2"
    cores: int
    mem_gb: float
    cpu_speed: float             # sysbench-like events/s
    mem_bw: float                # MiB/s
    io_seq: float = 482.0        # IOPS (same PD disks in the paper)
    io_rand: float = 105.0
    net_gbps: float = 16.0
    # Real application speed relative to what the microbenchmarks imply.
    # The paper itself cautions that "modern hardware is tailored to achieve
    # high scores in frequently used benchmarks"; cache sizes / turbo / IPC
    # make real task slowdowns on old nodes larger than sysbench ratios.
    # Benchmark observations ignore this; only the engine's ground truth
    # uses it (calibrated against the paper's Fig. 4/5 gaps, see DESIGN.md).
    app_factor: float = 1.0


@dataclasses.dataclass
class NodeProfile:
    node: str
    machine: str
    features: dict               # FEATURES -> measured value
    static: dict                 # cores, mem_gb, ...

    def vector(self) -> np.ndarray:
        return np.array([self.features[f] for f in FEATURES], np.float64)


def profile_node_synthetic(spec: NodeSpec, seed: int = 0) -> NodeProfile:
    # crc32-derived, not hash(): measurement noise must reproduce across
    # processes (hash() of a str is salted per interpreter)
    rng = np.random.default_rng((stable_seed(spec.name), seed))
    jitter = lambda v, rel: float(v * (1.0 + rng.uniform(-rel, rel)))
    feats = {
        "cpu": jitter(spec.cpu_speed, 0.02),
        "mem": jitter(spec.mem_bw, 0.015),
        "io_seq_read": jitter(spec.io_seq, 0.003),
        "io_seq_write": jitter(spec.io_seq, 0.003),
        "io_rand_read": jitter(spec.io_rand, 0.01),
        "io_rand_write": jitter(spec.io_rand, 0.01),
    }
    return NodeProfile(spec.name, spec.machine, feats,
                       {"cores": spec.cores, "mem_gb": spec.mem_gb,
                        "net_gbps": spec.net_gbps})


def profile_cluster_synthetic(specs: list[NodeSpec], seed: int = 0) -> list[NodeProfile]:
    return [profile_node_synthetic(s, seed) for s in specs]


# ----------------------------------------------------------- real benchmarks

def _bench_matmul(n: int = 1024, reps: int = 4) -> float:
    """GFLOP/s of an n x n f32 matmul (the 'CPU speed' analogue)."""
    x = np.ones((n, n), np.float32)
    x @ x
    t0 = time.perf_counter()
    for _ in range(reps):
        x @ x
    dt = (time.perf_counter() - t0) / reps
    return 2.0 * n ** 3 / dt / 1e9


def _bench_memstream(mb: int = 256, reps: int = 4) -> float:
    """GB/s of a host-memory stream (the 'memory speed' analogue)."""
    n = mb * 1024 * 1024 // 4
    x = np.ones((n,), np.float32)
    x + 1.0
    t0 = time.perf_counter()
    for _ in range(reps):
        x + 1.0
    dt = (time.perf_counter() - t0) / reps
    return 2.0 * n * 4 / dt / 1e9


def _bench_io(mb: int = 64, dir: str = None) -> tuple[float, float]:
    """(write MB/s, read MB/s) on a tmpfile (the fio analogue).  ``dir``
    points the tmpfile at a specific scratch volume (tmpfs vs disk) so the
    real-execution backend can profile per-node storage."""
    buf = os.urandom(mb * 1024 * 1024)
    with tempfile.NamedTemporaryFile(delete=False, dir=dir) as f:
        path = f.name
        t0 = time.perf_counter()
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
        w = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        f.read()
    r = mb / (time.perf_counter() - t0)
    os.unlink(path)
    return w, r


def _host_mem_gb() -> float:
    """Total host memory in GB (0.0 where /proc/meminfo is unavailable)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / 1024.0 ** 2   # kB -> GB
    except OSError:
        pass
    return 0.0


def _affinity_cores() -> int:
    """Cores *this process* may use — affinity-aware, so a backend child
    profiling its virtual node reports the node's core budget, not the
    whole machine's."""
    if hasattr(os, "sched_getaffinity"):
        try:
            return len(os.sched_getaffinity(0))
        except OSError:
            pass
    return os.cpu_count() or 1


def profile_local(name: str = "localhost", machine: str = "local", *,
                  matmul_n: int = 1024, stream_mb: int = 256,
                  io_mb: int = 64, reps: int = 4,
                  scratch: str = None) -> NodeProfile:
    """Benchmark the current host (under its current cpu affinity) into a
    NodeProfile.  Size parameters shrink the benchmarks for smoke tests
    and per-node backend profiling; ``scratch`` points the I/O benchmark
    at the node's storage volume."""
    gflops = _bench_matmul(matmul_n, reps)
    membw = _bench_memstream(stream_mb, reps)
    w, r = _bench_io(io_mb, dir=scratch)
    feats = {"cpu": gflops, "mem": membw, "io_seq_read": r, "io_seq_write": w,
             "io_rand_read": r, "io_rand_write": w}
    return NodeProfile(name, machine, feats,
                       {"cores": _affinity_cores(),
                        "mem_gb": _host_mem_gb()})
