"""Synthetic stand-ins for the five nf-core workflows of the evaluation
(§V-C): viralrecon, eager, mag, cageseq, chipseq.

Structures follow the Nextflow per-sample-channel model: equal-width stages
chain per sample (instance i of a stage depends on instance i of its parent),
report stages join everything.  Resource mixes follow Fig. 3: mag is
CPU-intensive; chipseq and eager are memory-intensive; viralrecon and cageseq
are the long runners.  Sample counts create enough concurrent mixed-demand
load that placement quality matters (10-12 samples x 2-core tasks vs. the
evaluation clusters' 60 reservable core-pairs).

Units: cpu work in sysbench-events (node speeds ~370-525 events/s);
mem work in MiB of traffic at the per-task bandwidth share; io in IOPS-s.
"""
from __future__ import annotations

from repro_torch.workflow.dag import AbstractTask as T, WorkflowSpec

_N2_CPU = 463.0
_N2_MEM = 17600.0 * 0.02     # effective per-task MiB/s share
_IO = 482.0


_SCALE = 1.0


def _w(cpu_s: float, mem_s: float, io_s: float) -> dict:
    return {"cpu": cpu_s * _N2_CPU * _SCALE, "mem": mem_s * _N2_MEM * _SCALE,
            "io": io_s * _IO * _SCALE}


def viralrecon() -> WorkflowSpec:
    S = 12                      # viral samples
    return WorkflowSpec("viralrecon", [
        T("fastqc",        S, _w(45, 12, 10), 1.2),
        T("trim",          S, _w(130, 30, 22), 1.8, deps=("fastqc",)),
        T("align",         S, _w(400, 150, 40), 3.8, deps=("trim",)),
        T("primer_trim",   S, _w(140, 60, 22), 2.2, deps=("align",)),
        T("call_variants", S, _w(360, 210, 28), 4.2, deps=("primer_trim",)),
        T("consensus",     S, _w(150, 85, 26), 2.5, deps=("call_variants",)),
        T("lineage",       4, _w(200, 55, 14), 2.0, deps=("consensus",)),
        T("multiqc",       1, _w(90, 40, 25), 1.5, deps=("lineage",)),
    ])


def eager() -> WorkflowSpec:
    S = 10                      # ancient-DNA libraries: heavy, memory-bound
    return WorkflowSpec("eager", [
        T("fastqc",      S, _w(45, 18, 10), 1.2),
        T("adapter_rm",  S, _w(110, 65, 18), 2.0, deps=("fastqc",)),
        T("map_aDNA",    S, _w(280, 420, 32), 4.4, deps=("adapter_rm",)),
        T("dedup",       S, _w(85, 250, 28), 4.0, deps=("map_aDNA",)),
        T("damage",      S, _w(190, 290, 14), 3.6, deps=("dedup",)),
        T("genotyping",  5, _w(250, 320, 18), 4.2, deps=("damage",)),
        T("report",      1, _w(60, 40, 15), 1.4, deps=("genotyping",)),
    ])


def mag() -> WorkflowSpec:
    S = 10                      # metagenome bins: CPU-hungry assembly
    return WorkflowSpec("mag", [
        T("fastqc",    S, _w(45, 12, 10), 1.2),
        T("host_rm",   S, _w(240, 75, 26), 2.6, deps=("fastqc",)),
        T("assembly",  S, _w(850, 170, 38), 4.5, deps=("host_rm",)),
        T("binning",   S, _w(500, 110, 28), 3.0, deps=("assembly",)),
        T("checkm",    S, _w(360, 85, 14), 2.6, deps=("binning",)),
        T("annotate",  5, _w(400, 65, 18), 2.2, deps=("checkm",)),
    ])


def cageseq() -> WorkflowSpec:
    S = 12
    return WorkflowSpec("cageseq", [
        T("fastqc",     S, _w(50, 12, 10), 1.2),
        T("trim_cage",  S, _w(160, 42, 20), 1.8, deps=("fastqc",)),
        T("align_bwt",  S, _w(490, 180, 38), 3.6, deps=("trim_cage",)),
        T("ctss",       S, _w(220, 130, 28), 2.8, deps=("align_bwt",)),
        T("cluster_tc", 6, _w(400, 190, 18), 3.2, deps=("ctss",)),
        T("qc_report",  1, _w(100, 40, 25), 1.5, deps=("cluster_tc",)),
    ])


def chipseq() -> WorkflowSpec:
    S = 11                      # peak calling: memory-heavy
    return WorkflowSpec("chipseq", [
        T("fastqc",     S, _w(45, 16, 10), 1.2),
        T("trim",       S, _w(110, 38, 18), 1.6, deps=("fastqc",)),
        T("bwa_mem",    S, _w(280, 360, 32), 4.4, deps=("trim",)),
        T("filter_bam", S, _w(100, 240, 28), 3.8, deps=("bwa_mem",)),
        T("macs2",      S, _w(240, 340, 18), 4.3, deps=("filter_bam",)),
        T("annotate",   5, _w(170, 150, 14), 2.4, deps=("macs2",)),
        T("multiqc",    1, _w(80, 40, 20), 1.5, deps=("annotate",)),
    ])


WORKFLOWS = {
    "viralrecon": viralrecon,
    "eager": eager,
    "mag": mag,
    "cageseq": cageseq,
    "chipseq": chipseq,
}
