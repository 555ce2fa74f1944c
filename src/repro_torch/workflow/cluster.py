"""The paper's two evaluation clusters (§V-B, Tables II/III) as NodeSpec sets.

Ground-truth speeds are set so the synthetic profiler reproduces the ranges
of Table IV: three hardware tiers (Broadwell / Cascade-Lake / compute-
optimized Cascade-Lake), identical I/O (one shared persistent volume).
"""
from __future__ import annotations

from repro_torch.core.profiler import NodeSpec


APP_FACTOR = {"e2": 0.74, "n1": 0.78, "n2": 1.0, "c2": 1.02}


def _mk(prefix, machine, n, cores, mem, cpu, membw, net):
    return [NodeSpec(f"{prefix}-{machine}-{i}", machine, cores, mem,
                     cpu_speed=cpu, mem_bw=membw, net_gbps=net,
                     app_factor=APP_FACTOR[machine])
            for i in range(n)]


def cluster_555() -> list[NodeSpec]:
    """Table II: 5x N1 + 5x N2 + 5x C2, uniform 8 vCPU / 32 GB."""
    return (_mk("a", "n1", 5, 8, 32, 375.0, 14050.0, 16)
            + _mk("a", "n2", 5, 8, 32, 463.0, 17600.0, 16)
            + _mk("a", "c2", 5, 8, 32, 524.0, 19850.0, 16))


def cluster_5442() -> list[NodeSpec]:
    """Table III: 5x E2(6c/16G) + 4x N1(6c/16G) + 4x N2(8c/32G) + 2x C2(16c/64G).

    E2 and N1 share the Broadwell performance band, so profiling groups them
    together (9 nodes in group 1, matching Table IV).
    """
    return (_mk("b", "e2", 5, 6, 16, 372.0, 13400.0, 8)
            + _mk("b", "n1", 4, 6, 16, 378.0, 13900.0, 10)
            + _mk("b", "n2", 4, 8, 32, 469.5, 17750.0, 16)
            + _mk("b", "c2", 2, 16, 64, 523.0, 19800.0, 32))


CLUSTERS = {"5;5;5": cluster_555, "5;4;4;2": cluster_5442}
