"""Roofline model and per-phase performance attribution — the port's twin
of ``fedml_tpu/telemetry/profiling/roofline.py``.

Williams et al., "Roofline: An Insightful Visual Performance Model"
(CACM '09): a program whose arithmetic intensity AI = flops / bytes lies
below the machine balance (peak FLOP/s ÷ peak memory bandwidth) is
bandwidth-bound however well it schedules; above it, compute-bound. This
module owns the card's peak tables (``chip_smoke.py`` reads them too),
the classification and the report's attribution join: measured phase
walls (spans) × the catalog's flops and bytes (``programs.jsonl``) →
achieved FLOP/s, bytes/s and a per-phase MFU.

The tables hold NVIDIA cards only, keyed by the names
``torch.cuda.get_device_name()`` returns (dense bf16 rates without
sparsity, HBM bandwidth; NVIDIA's data sheets). A device the tables do not
name (a CPU, a TPU named by a JAX run dir) gets no peaks and the nominal
:data:`DEFAULT_RIDGE`, as in the reference.

The port's catalog counts flops and bytes itself (``catalog.py``), where
the reference reads XLA's ``cost_analysis()``: the whole-run row's
``provenance`` says which of the two a run dir's programs came from.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "PEAK_BF16",
    "PEAK_FLOPS",
    "PEAK_HBM_BW",
    "DEFAULT_RIDGE",
    "arithmetic_intensity",
    "build_attribution",
    "classify",
    "device_peaks",
    "ridge_point",
]

# dense bf16 FLOP/s by device name (NVIDIA data sheets)
PEAK_FLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,  # SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H200": 989e12,
}
PEAK_BF16 = PEAK_FLOPS  # the reference's historical name

# HBM bandwidth, bytes/s (NVIDIA data sheets)
PEAK_HBM_BW: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H200": 4.8e12,
}

# machine balance used when the device is unknown (CPU boxes, unlisted
# cards): programs denser than this many flops/byte are called
# compute-bound. Nominal, overridable via FEDML_PEAK_*.
DEFAULT_RIDGE = 10.0


def device_peaks(device_kind: Optional[str] = None
                 ) -> Tuple[Optional[float], Optional[float]]:
    """(peak FLOP/s, peak bytes/s) for ``device_kind`` (default: the name
    of CUDA device 0, none without a card). ``FEDML_PEAK_FLOPS`` /
    ``FEDML_PEAK_BW`` env overrides win — that is how CPU test rigs and
    unlisted cards get deterministic MFU and roofline numbers."""
    flops = os.environ.get("FEDML_PEAK_FLOPS")
    bw = os.environ.get("FEDML_PEAK_BW")
    if flops or bw:
        return (float(flops) if flops else None,
                float(bw) if bw else None)
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return None, None
        device_kind = torch.cuda.get_device_name(0)
    return PEAK_FLOPS.get(device_kind), PEAK_HBM_BW.get(device_kind)


def ridge_point(peaks: Optional[Tuple[Optional[float],
                                      Optional[float]]] = None) -> float:
    """Machine balance (flops/byte) — the roofline's compute/bandwidth
    boundary. Falls back to :data:`DEFAULT_RIDGE` when either peak is
    unknown."""
    if peaks is None:
        peaks = device_peaks()
    pf, pb = peaks
    if pf and pb:
        return pf / pb
    return DEFAULT_RIDGE


def arithmetic_intensity(flops: float, bytes_accessed: float
                         ) -> Optional[float]:
    if not flops or not bytes_accessed:
        return None
    return flops / bytes_accessed


def classify(ai: Optional[float],
             ridge: Optional[float] = None) -> Optional[str]:
    """``"compute-bound"`` or ``"hbm-bound"`` (None when AI unknown)."""
    if ai is None:
        return None
    if ridge is None:
        ridge = ridge_point()
    return "compute-bound" if ai >= ridge else "hbm-bound"


_ROUND_PHASE = re.compile(r"^round/<n>/")


def _provenance(programs: List[Dict[str, Any]]) -> str:
    """``xla`` for the reference's rows (their ``treedef`` is a JAX
    ``PyTreeDef``: the figures are XLA's ``cost_analysis()``), ``counted``
    for the port's (its catalog's counting context)."""
    if any(str(rec.get("treedef") or "").startswith("PyTreeDef")
           for rec in programs):
        return "xla"
    return "counted"


def build_attribution(phases: List[Dict[str, Any]],
                      rounds: List[Dict[str, Any]],
                      programs: List[Dict[str, Any]],
                      device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Join measured phase walls against the program catalog.

    ``phases``/``rounds`` are the report's span-derived rows;
    ``programs`` the loaded ``programs.jsonl`` records. Returns the
    report's ``attribution`` section: per-program roofline rows, per-phase
    achieved FLOP/s + bytes/s + MFU, the whole-run decomposition, and the
    top peak-memory consumer.
    """
    peaks = device_peaks(device_kind)
    ridge = ridge_point(peaks)
    pf, pb = peaks

    program_rows: List[Dict[str, Any]] = []
    by_phase: Dict[str, Dict[str, float]] = {}
    for rec in programs:
        flops = float(rec.get("flops") or 0.0)
        nbytes = float(rec.get("bytes_accessed") or 0.0)
        ai = arithmetic_intensity(flops, nbytes)
        program_rows.append({
            "name": rec.get("name"),
            "calls": int(rec.get("calls") or 0),
            "flops": flops,
            "bytes_accessed": nbytes,
            "peak_hbm_bytes": float(rec.get("peak_hbm_bytes") or 0.0),
            "compile_ms": float(rec.get("compile_ms") or 0.0),
            "recompiles": int(rec.get("recompiles") or 0),
            "multi_shape": bool(rec.get("multi_shape")),
            "mesh_spec": rec.get("mesh_spec"),
            "arithmetic_intensity": ai,
            "roofline_class": classify(ai, ridge),
        })
        for phase, calls in (rec.get("phase_calls") or {}).items():
            agg = by_phase.setdefault(phase, {"flops": 0.0, "bytes": 0.0,
                                              "calls": 0.0})
            agg["flops"] += flops * int(calls)
            agg["bytes"] += nbytes * int(calls)
            agg["calls"] += int(calls)
    program_rows.sort(key=lambda r: -r["flops"] * max(r["calls"], 1))

    phase_wall_ms = {p["phase"]: float(p.get("total_ms") or 0.0)
                     for p in phases}
    phase_rows: List[Dict[str, Any]] = []
    total_flops = total_bytes = attributed_wall_ms = 0.0
    for phase in sorted(by_phase):
        agg = by_phase[phase]
        wall_ms = phase_wall_ms.get(phase, 0.0)
        row: Dict[str, Any] = {
            "phase": phase,
            "calls": int(agg["calls"]),
            "flops": agg["flops"],
            "bytes_accessed": agg["bytes"],
            "wall_ms": wall_ms,
        }
        ai = arithmetic_intensity(agg["flops"], agg["bytes"])
        row["arithmetic_intensity"] = ai
        row["roofline_class"] = classify(ai, ridge)
        if wall_ms > 0:
            wall_s = wall_ms / 1e3
            row["achieved_flops_per_s"] = agg["flops"] / wall_s
            row["achieved_bytes_per_s"] = agg["bytes"] / wall_s
            if pf:
                row["mfu"] = agg["flops"] / wall_s / pf
            if pb:
                row["bw_utilization"] = agg["bytes"] / wall_s / pb
            if _ROUND_PHASE.match(phase):
                # round phases are wall-disjoint within a round, so their
                # flops AND walls sum into the whole-run decomposition
                total_flops += agg["flops"]
                total_bytes += agg["bytes"]
                attributed_wall_ms += wall_ms
        phase_rows.append(row)

    round_wall_ms = sum(float(r.get("wall_ms") or 0.0) for r in rounds)
    overall: Dict[str, Any] = {
        "flops": total_flops,
        "bytes_accessed": total_bytes,
        "attributed_wall_ms": attributed_wall_ms,
        "round_wall_ms": round_wall_ms,
        "provenance": _provenance(programs),
    }
    wall = round_wall_ms or attributed_wall_ms
    if wall > 0 and total_flops:
        overall["achieved_flops_per_s"] = total_flops / (wall / 1e3)
        if pf:
            overall["mfu"] = total_flops / (wall / 1e3) / pf
    top_hbm = max(program_rows, key=lambda r: r["peak_hbm_bytes"],
                  default=None)
    return {
        "device_kind": device_kind,
        "peak_flops_per_s": pf,
        "peak_bytes_per_s": pb,
        "ridge_flops_per_byte": ridge,
        "programs": program_rows,
        "phases": phase_rows,
        "overall": overall,
        "top_hbm_program": (top_hbm if top_hbm
                            and top_hbm["peak_hbm_bytes"] > 0 else None),
    }
