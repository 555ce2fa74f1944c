"""Drive the PyTorch port of Tarema on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs from the root of a checkout; builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` on first use.  Phases, in order; any
failure exits non-zero:

1. card: name and power limit (``nvidia-smi``), ``torch`` device name;
2. build: ``nvcc`` for sm_90a, with ptxas's register / shared-memory /
   spill report and the build time;
3. kernels against their plain PyTorch versions on the card, at the fleet
   probe's shape (10^5 x 3, k = 2..4), the fleet's node profiles
   (1,000 x 6, k = 2..6) and the kernels' envelope with a ragged N
   (65,537 x 128, k = 64): labels and counts exact on well-separated data
   whose nearest-centre distances are about 1, distances atol 1e-3, sums
   atol 1e-3 + rtol 1e-5, two launches bitwise equal; each timed with
   CUDA events (median of 100 launches after a warm-up) beside its bound
   and the plain version's time;
4. main path one: ``choose_k`` on 10^5 fleet-probe profiles on the card
   must find k = 3 and the CPU run's partition;
5. main path two: a Tarema engine run on 1,000 nodes x 50,000 task
   instances (after a label warm-up run), every instance completed,
   grouping k = 3; then a paper-cluster run on the card must place exactly
   as the same run on the CPU.

Each main path has its own launch counts: the counters are zeroed just
before the path and read just after it, and each kernel must have
launched exactly as often as the path's ``choose_k`` calls need.  The
CPU comparison runs, the traced rerun and the paper-cluster check lie
outside those windows.  The last three lines are the kernels' JSON
record, the card's name and power limit, and the result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core.clustering import choose_k  # noqa: E402
from repro_torch.core.monitor import TraceDB  # noqa: E402
from repro_torch.core.profiler import NodeSpec  # noqa: E402
from repro_torch.core.scheduler import make_scheduler  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import kmeans as km  # noqa: E402
from repro_torch.workflow.cluster import cluster_555  # noqa: E402
from repro_torch.workflow.dag import AbstractTask, WorkflowSpec  # noqa: E402
from repro_torch.workflow.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.workflow.nfcore import WORKFLOWS  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
# tensor cores in FLOP/s.  The bound of a call is the larger of its bytes
# over the first and its operations over the second.
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SOURCE = "src/repro_torch/kernels/csrc/kmeans.cu"
REPLACES = {"kmeans_assign": "src/repro/kernels/kmeans.py:48",
            "kmeans_lloyd_step": "src/repro/kernels/kmeans.py:106"}
SHAPES = ([(100_000, 3, k) for k in (2, 3, 4)]
          + [(1000, 6, k) for k in range(2, 7)]
          + [(65_537, 128, 64)])
RECORD_SHAPE = (100_000, 3, 3)     # the fleet probe's grouping at k = 3
PROBE_PROFILES = 100_000           # engine_bench's full-scale k-means probe
FLEET_NODES, FLEET_INSTANCES = 1000, 50_000   # engine_bench's full scale

# ---- fleet workload (the engine benchmark's fleet, copied: the paper's
# three 8-vCPU tiers replicated; stages cycle cpu/mem/io-heavy signatures)
_TIERS = (("n1", 375.0, 14050.0, 0.78), ("n2", 463.0, 17600.0, 1.0),
          ("c2", 524.0, 19850.0, 1.02))
_REQ_CORES, _REQ_MEM = 4, 8.0
_SIGNATURES = (
    ("cpu_heavy", 900.0 * 463.0, 40.0 * 352.0, 10.0 * 482.0),
    ("mem_heavy", 250.0 * 463.0, 300.0 * 352.0, 20.0 * 482.0),
    ("io_heavy", 200.0 * 463.0, 50.0 * 352.0, 60.0 * 482.0),
    ("balanced", 400.0 * 463.0, 120.0 * 352.0, 25.0 * 482.0),
)


def fleet_cluster(n_nodes: int) -> list[NodeSpec]:
    specs = []
    for i in range(n_nodes):
        machine, cpu, membw, app = _TIERS[i % len(_TIERS)]
        specs.append(NodeSpec(f"f-{machine}-{i:05d}", machine, 8, 32.0,
                              cpu_speed=cpu, mem_bw=membw, app_factor=app))
    return specs


def fleet_workflow(n_instances: int, width: int,
                   name: str = "fleet") -> WorkflowSpec:
    """Equal-width stage chain totalling ``n_instances`` task instances."""
    n_stages = max(1, math.ceil(n_instances / width))
    tasks = []
    for s in range(n_stages):
        w = width if s < n_stages - 1 else n_instances - width * (n_stages - 1)
        sig, cpu, mem, io = _SIGNATURES[s % len(_SIGNATURES)]
        tasks.append(AbstractTask(
            f"s{s:03d}_{sig}", max(w, 1),
            {"cpu": cpu, "mem": mem, "io": io},
            peak_mem_gb=4.0, deps=(tasks[-1].name,) if tasks else (),
            req_cores=_REQ_CORES, req_mem_gb=_REQ_MEM))
    return WorkflowSpec(name, tasks)


def fleet_probe(n: int, seed: int = 0) -> np.ndarray:
    """10^5-scale node profiles: three tiers, 1% jitter, shared I/O."""
    rng = np.random.default_rng(seed)
    centers = np.array([[375.0, 14050.0], [463.0, 17600.0], [524.0, 19850.0]])
    tier = rng.integers(0, 3, n)
    return np.c_[centers[tier] * (1.0 + rng.normal(0, 0.01, (n, 2))),
                 np.full((n, 1), 482.0)
                 * (1.0 + rng.normal(0, 0.003, (n, 1)))]


# ---- helpers

def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def same_partition(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) \
        == len(set(np.asarray(b).tolist()))


def blobs(n: int, f: int, k: int, seed: int):
    """Well-separated clusters and starting centres near the true ones,
    float32.  Centres have norm about 8 and lie at least 6 apart; the
    noise is 1/sqrt(f) per coordinate, so a point's squared distance to
    its centre is about 1 (a tolerance of 1e-3 on it means something) and
    a boundary between two centres lies over 5 noise deviations away."""
    rng = np.random.default_rng(seed)
    while True:
        c = rng.standard_normal((k, f)) * (8.0 / math.sqrt(f))
        gaps = np.linalg.norm(c[:, None] - c[None], axis=-1)
        if k == 1 or gaps[~np.eye(k, dtype=bool)].min() >= 6.0:
            break
    x = (c[rng.integers(0, k, n)]
         + rng.standard_normal((n, f)) * (1.0 / math.sqrt(f)))
    c0 = c + rng.standard_normal((k, f)) * 0.01
    return x.astype(np.float32), c0.astype(np.float32)


def time_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def device_profile(fn) -> tuple[float, list]:
    """Device-side kernel time of ``fn()`` from torch.profiler (CUPTI):
    (total ms, [(kernel, calls, total ms)] largest first).  The total is
    0.0 where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key[:60], e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows


def choose_k_launches(n: int, k_max: int, restarts: int) -> dict:
    """Launches of one ``choose_k`` on the card: per k and restart, k - 1
    assigns for the k-means++ distances, 32 Lloyd steps and one assign
    for the inertia."""
    ks = range(2, min(k_max, n - 1) + 1)
    return {"kmeans_assign": restarts * sum(k for k in ks),
            "kmeans_lloyd_step": restarts * 32 * len(ks)}


def zero_counts() -> None:
    km.kmeans_assign.launches = 0
    km.kmeans_lloyd_step.launches = 0


def read_counts(path: str, want: dict) -> dict:
    got = {"kmeans_assign": km.kmeans_assign.launches,
           "kmeans_lloyd_step": km.kmeans_lloyd_step.launches}
    print(f"  launches on {path}: {got} (its choose_k calls need {want})")
    check(got == want, f"{path}: launches {got}, expected {want}")
    return got


def bound_ms(name: str, n: int, f: int, k: int) -> tuple[float, str]:
    """Least time for the function on these inputs: every input read once,
    every output written once, the flops of the distance formula (and of
    the per-cluster sums for the Lloyd step)."""
    nbytes = 4 * (n * f + k * f) + 8 * n
    flops = n * k * (2 * f + 3) + 2 * n * f
    if name == "kmeans_lloyd_step":
        nbytes += 4 * (k * f + k)
        flops += n * (f + 1)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


# ---- phases

def phase_kernels(dev) -> dict:
    """Kernels against plain versions; returns per-kernel records."""
    rec = {name: {"max_abs_err": 0.0} for name in REPLACES}
    print("phase 3: kernels vs plain  (N, f, k | kernel ms per call | "
          "its device-only ms | plain ms | bound ms, by | max |err| | "
          "mean distance)")
    for n, f, k in SHAPES:
        x_np, c_np = blobs(n, f, k, seed=n + 1000 * f + k)
        x = torch.from_numpy(x_np).to(dev)
        c = torch.from_numpy(c_np).to(dev)
        runs = {"kmeans_assign": (km.kmeans_assign, km.kmeans_assign_plain),
                "kmeans_lloyd_step": (km.kmeans_lloyd_step,
                                      km.kmeans_lloyd_step_plain)}
        for name, (kernel, plain) in runs.items():
            a, b, want = kernel(x, c), kernel(x, c), plain(x, c)
            torch.cuda.synchronize()
            for u, v in zip(a, b):
                check(torch.equal(u, v), f"{name} {n}x{f} k={k}: two "
                      "launches differ")
            check(torch.equal(a[0], want[0]),
                  f"{name} {n}x{f} k={k}: labels differ from plain")
            err = float((a[1] - want[1]).abs().max())
            mean_d = float(want[1].mean())
            check(err <= 1e-3, f"{name} {n}x{f} k={k}: distance error {err}")
            if name == "kmeans_lloyd_step":
                check(torch.equal(a[3], want[3]),
                      f"{name} {n}x{f} k={k}: counts differ from plain")
                check(float(a[3].sum()) == n, f"{name}: counts do not sum "
                      "to N")
                check(torch.allclose(a[2], want[2], rtol=1e-5, atol=1e-3),
                      f"{name} {n}x{f} k={k}: sums differ from plain")
                err = max(err, float((a[2] - want[2]).abs().max()))
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
            ms = time_ms(lambda: kernel(x, c))
            plain_ms = time_ms(lambda: plain(x, c))
            dev_ms = device_profile(
                lambda: [kernel(x, c) for _ in range(20)])[0] / 20
            bms, by = bound_ms(name, n, f, k)
            print(f"  {name:18s} {n:6d} {f:3d} {k:2d} | {ms:.6f} | "
                  f"{dev_ms:.6f} | {plain_ms:.6f} | {bms:.6f} {by} | "
                  f"{err:.3e} | {mean_d:.4f}")
            if (n, f, k) == RECORD_SHAPE:
                rec[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=by)
    return rec


def phase_choose_k(dev) -> dict:
    """Main path one; returns its launch counts."""
    n = PROBE_PROFILES
    X = fleet_probe(n)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    got = choose_k(X, k_max=4, restarts=2, device=dev)
    wall = time.perf_counter() - t0
    launches = read_counts("the fleet-probe choose_k",
                           choose_k_launches(n, 4, 2))
    t0 = time.perf_counter()
    want = choose_k(X, k_max=4, restarts=2, device="cpu")
    cpu_wall = time.perf_counter() - t0
    print(f"phase 4: choose_k {n} x 3 on the card: k={got['k']} "
          f"per_k={got['per_k']} wall_s={wall:.6f} (CPU run: k={want['k']}, "
          f"wall_s={cpu_wall:.6f})")
    check(got["k"] == 3, f"choose_k found k={got['k']}, not 3")
    t0 = time.perf_counter()
    busy, rows = device_profile(
        lambda: choose_k(X, k_max=4, restarts=2, device=dev))
    traced = time.perf_counter() - t0
    print(f"  traced rerun: device busy {busy:.6f} ms of {traced * 1e3:.6f} "
          f"ms wall (profiler on); top kernels (name, calls, ms):")
    for row in rows[:8]:
        print(f"    {row[0]:60s} {row[1]:6d} {row[2]:.6f}")
    check(want["k"] == 3 and same_partition(got["labels"], want["labels"]),
          "choose_k on the card and on the CPU disagree")
    return launches


def phase_engine(dev) -> dict:
    """Main path two (the two scheduler builds and both engine runs);
    returns its launch counts."""
    n_nodes, n_instances = FLEET_NODES, FLEET_INSTANCES
    specs = fleet_cluster(n_nodes)
    width = n_nodes * (8 // _REQ_CORES)
    db = TraceDB()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    warm_sched = make_scheduler("tarema", specs, seed=1, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"phase 5: one Tarema scheduler over {n_nodes} nodes "
          f"(choose_k k_max=6 restarts=4): {build_s:.6f} s, launches "
          f"assign={km.kmeans_assign.launches} "
          f"lloyd={km.kmeans_lloyd_step.launches}")
    warm = fleet_workflow(max(1, math.ceil(n_instances / width)), 1)
    weng = Engine(specs, warm_sched, db, EngineConfig(seed=1))
    weng.submit(warm, run_id=0, seed=5)
    weng.run()
    sched = make_scheduler("tarema", specs, seed=3, device=dev)
    eng = Engine(specs, sched, db, EngineConfig(seed=0))
    eng.submit(fleet_workflow(n_instances, width), run_id=1, seed=7)
    t0 = time.perf_counter()
    res = eng.run()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    one = choose_k_launches(n_nodes, 6, 4)
    launches = read_counts("the 1,000-node Tarema run (two scheduler "
                           "builds)", {name: 2 * v for name, v in one.items()})
    done = len(res["assignments"])
    print(f"  engine {n_nodes} x {n_instances}: makespan={res['makespan']} "
          f"wall_s={wall:.6f} completed={done} k={sched.grouping['k']} "
          f"phase_wall={getattr(eng, 'phase_wall', None)}")
    check(done == n_instances, f"{done} of {n_instances} instances completed")
    check(math.isfinite(res["makespan"]) and res["makespan"] > 0,
          "makespan not finite and positive")
    check(sched.grouping["k"] == 3, f"fleet grouped into "
          f"k={sched.grouping['k']}, not 3")

    # the same small run on the card and on the CPU must place identically
    out = {}
    for where in (dev, "cpu"):
        small = cluster_555()
        sdb = TraceDB()
        trace = []
        for run in range(2):
            s = make_scheduler("tarema", small, seed=run, device=where)
            e = Engine(small, s, sdb, EngineConfig(seed=run))
            e.submit(WORKFLOWS["viralrecon"](), run_id=run, seed=0)
            r = e.run()
            trace.append((r["makespan"], r["assignments"]))
        out[str(where)] = trace
    check(out[str(dev)] == out["cpu"], "paper-cluster Tarema runs on the "
          "card and on the CPU place differently")
    print(f"  paper cluster 5;5;5, two Tarema runs: makespans "
          f"{[t[0] for t in out['cpu']]} on both devices")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # the plain versions are the yardstick: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card: {card} | torch: {kind} | torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    b = build.build("kmeans")
    build.kmeans_library()
    print(f"phase 2: built {os.path.relpath(b.path)} in {b.seconds:.6f} s "
          f"(0 means it was already built)")
    print(b.log.rstrip())

    rec = phase_kernels(dev)

    paths = {"choose_k_fleet_probe": phase_choose_k(dev),
             "tarema_fleet_run": phase_engine(dev)}
    for path, counts in paths.items():
        for name, count in counts.items():
            check(count > 0, f"{name} was not launched on {path}")

    # "launches" is the count of the Tarema run, the path a user drives
    # through make_scheduler and the engine; every path's own count is
    # in "launches_by_path".
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": paths["tarema_fleet_run"][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": rec[name]["max_abs_err"],
                "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
                "bound_ms": rec[name]["bound_ms"],
                "bound_by": rec[name]["bound_by"], "library_ms": None}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
