"""Performance attribution layer — program catalog, roofline, device
traces (ROADMAP A12b1). The port's counterpart of
``fedml_tpu.telemetry.profiling``.

Three parts:

- :mod:`.catalog` — a process-wide registry where every hot-path program
  registers under a stable name (:func:`wrap_program`, the reference's
  ``wrap_jit``) and records, at the first call of each input signature,
  its product FLOPs and bytes (a counting dispatch mode plus the costs the
  port's kernels declare), argument/output bytes, the allocator's peak,
  kernel-build time and recompile count; persisted as ``programs.jsonl``
  per run and streamed as ``profile/*`` gauges;
- :mod:`.roofline` — the card's peak tables (NVIDIA H100 / H200) +
  arithmetic-intensity classification and the report's per-phase
  attribution join (achieved FLOP/s, bytes/s, MFU);
- :mod:`.trace` — the budgeted :class:`TraceController` on
  ``torch.profiler`` with explicit, manual and requested capture arms
  (one trace owner per process).
"""
from fedml_tpu_torch.telemetry.profiling.catalog import (
    CatalogedProgram,
    ProgramCatalog,
    ProgramRecord,
    get_catalog,
    kernel_cost,
    pump_profile_gauges,
    repeated_cost,
    reset_catalog,
    wrap_program,
)
from fedml_tpu_torch.telemetry.profiling.roofline import (
    DEFAULT_RIDGE,
    PEAK_BF16,
    PEAK_FLOPS,
    PEAK_HBM_BW,
    arithmetic_intensity,
    build_attribution,
    classify,
    device_peaks,
    ridge_point,
)
from fedml_tpu_torch.telemetry.profiling.trace import (
    AUTO_CAPTURE_RULES,
    TraceController,
    get_trace_controller,
    parse_rounds,
    reset_trace_controller,
)

__all__ = [
    "AUTO_CAPTURE_RULES",
    "CatalogedProgram",
    "DEFAULT_RIDGE",
    "PEAK_BF16",
    "PEAK_FLOPS",
    "PEAK_HBM_BW",
    "ProgramCatalog",
    "ProgramRecord",
    "TraceController",
    "arithmetic_intensity",
    "build_attribution",
    "classify",
    "device_peaks",
    "get_catalog",
    "get_trace_controller",
    "kernel_cost",
    "parse_rounds",
    "pump_profile_gauges",
    "repeated_cost",
    "reset_catalog",
    "reset_trace_controller",
    "ridge_point",
    "wrap_program",
]
