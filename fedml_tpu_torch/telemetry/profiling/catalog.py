"""Program catalog — every hot-path program of the port, named and
accounted. The port's counterpart of
``fedml_tpu/telemetry/profiling/catalog.py``.

The reference registers each hot-path jitted function under a stable name
(``wrap_jit``) and reads XLA's ``cost_analysis()`` and
``memory_analysis()`` off the compiled executable. The port runs eagerly
and has no executable to ask, so :func:`wrap_program` wraps the Python
function itself and measures its first call of each input signature:

- **signature**: shapes and dtypes of the tensor leaves of the arguments,
  the container structure around them and the type of every other leaf
  (``static_argnums`` by value, as the reference's static args). Each new
  signature is a new variant: ``n_signatures``, ``recompiles``. A variant
  is measured once in the catalog's life and shared by every wrapper of
  the same name (each in-process silo's trainer wraps its own step);
- **flops**: the floating-point work of PyTorch's product ops (matmuls,
  convolutions, attention), by ``torch.utils.flop_counter``'s formulas, in
  a counting dispatch mode around the first call, plus the cost that each
  of the port's own kernels declares at its launch (:func:`kernel_cost`:
  flash attention's three kernels, the int8 dequant matmul). Elementwise
  work is left out, where XLA's ``cost_analysis()`` counts it. A loop whose
  iterations do the same work (the local steps) marks them
  (:func:`repeated_cost`): one iteration of each kind is counted and taken
  as many times as the loop runs it, so counting costs about one step;
- **bytes_accessed**: every op's input plus output bytes (views and bare
  allocations excepted): the port runs eagerly, without fusion, so that is
  what it reads and writes; a kernel adds the bytes it declares;
- **memory**: ``argument_bytes`` and ``output_bytes`` from the tensors (an
  ``nn.Module`` argument counts its parameters and buffers);
  ``peak_hbm_bytes`` is the CUDA allocator's high-water mark during the
  first call when that call raised it (``max_memory_allocated``), else the
  larger of the bytes allocated before and after the call (a lower bound),
  and 0 on the CPU. The catalog never resets the peak statistics, so a
  caller that resets and reads them sees what it would see without it;
- **compile time**: ``compile_ms`` / ``compile_events`` are the first-use
  kernel builds of ``ops/_build.py`` made while the program is on this
  thread's stack (``telemetry.note_kernel_build``); builds outside any
  program are ``uncataloged``. ``compile_wall_ms`` is the wall of each
  variant's first (counted) call.

A cataloged call made while another cataloged program is on the stack
runs straight through and counts for the outer program only (the LLM
round calls the train step each step: the reference's fused round is one
program). After the first call of a variant the wrapper computes the
signature, looks the variant up and counts the call: tens of µs of host
time. ``FEDML_PROFILE=0`` makes every wrapper a passthrough.

Snapshots persist as ``<run_dir>/programs.jsonl`` (one line per program,
the reference's keys) and as ``profile/*`` registry gauges.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode,
    _get_current_dispatch_mode_stack,
    _pop_mode_temporarily,
)

from fedml_tpu_torch.telemetry.registry import get_registry

__all__ = [
    "CatalogedProgram",
    "ProgramCatalog",
    "ProgramRecord",
    "get_catalog",
    "kernel_cost",
    "pump_profile_gauges",
    "repeated_cost",
    "reset_catalog",
    "wrap_program",
]

# the program whose wrapped call is on this thread's stack: kernel builds
# are booked to it, and a cataloged call under it runs straight through
_PROGRAM_VAR: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "fedml_profile_program", default=None)

_ENV_DISABLE = "FEDML_PROFILE"  # "0" disables the catalog process-wide


def _enabled_from_env() -> bool:
    return os.environ.get(_ENV_DISABLE, "1") not in ("0", "false", "off")


class _Variant:
    """The measured cost of one input signature of a cataloged program."""

    __slots__ = ("flops", "bytes_accessed")

    def __init__(self, flops: float = 0.0, bytes_accessed: float = 0.0):
        self.flops = flops
        self.bytes_accessed = bytes_accessed


class ProgramRecord:
    """Mutable accounting for one named program (all variants)."""

    def __init__(self, name: str, multi_shape: bool = False):
        self.name = name
        self.multi_shape = bool(multi_shape)
        self.flops = 0.0            # latest-variant flops
        self.bytes_accessed = 0.0   # latest-variant bytes accessed
        self.argument_bytes = 0.0
        self.output_bytes = 0.0
        self.temp_bytes = 0.0
        self.peak_hbm_bytes = 0.0   # max over variants (see module doc)
        self.generated_code_bytes = 0.0  # eager: no generated code
        self.compile_ms = 0.0       # kernel builds booked here
        self.compile_wall_ms = 0.0  # first-call walls of the variants
        self.compile_events = 0     # kernel builds booked here
        self.n_signatures = 0       # distinct input signatures
        self.calls = 0
        self.fallback_calls = 0     # calls that could not be keyed
        self.analysis_error: Optional[str] = None
        self.treedef: Optional[str] = None
        self.first_call_ts: Optional[float] = None
        self.phase_calls: Dict[str, int] = {}
        self.mesh_spec: Optional[Dict[str, Any]] = None  # single device

    def to_dict(self) -> Dict[str, Any]:
        from fedml_tpu_torch.telemetry.profiling.roofline import (
            arithmetic_intensity,
            classify,
        )

        ai = arithmetic_intensity(self.flops, self.bytes_accessed)
        return {
            "name": self.name,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "compile_ms": round(self.compile_ms, 3),
            "compile_wall_ms": round(self.compile_wall_ms, 3),
            "compile_events": self.compile_events,
            "n_signatures": self.n_signatures,
            "recompiles": max(self.n_signatures - 1, 0),
            "multi_shape": self.multi_shape,
            "calls": self.calls,
            "fallback_calls": self.fallback_calls,
            "analysis_error": self.analysis_error,
            "treedef": self.treedef,
            "phase_calls": dict(self.phase_calls),
            "mesh_spec": self.mesh_spec,
            "arithmetic_intensity": ai,
            "roofline_class": classify(ai) if ai is not None else None,
        }


def _phase_of(span_name: Optional[str], memo: Dict[str, str]) -> str:
    """Normalize the enclosing span's name to a stable phase key
    (``round/3/client/7/train`` → ``round/<n>/client/<id>/train``)."""
    if not span_name:
        return "unattributed"
    hit = memo.get(span_name)
    if hit is not None:
        return hit
    from fedml_tpu_torch.telemetry.report import normalize_name

    phase = normalize_name(span_name)
    if len(memo) < 4096:  # runs are rounds×phases; cap pathological churn
        memo[span_name] = phase
    return phase


# -- signatures -----------------------------------------------------------------
def _tree_sig(x: Any) -> Any:
    """Hashable structure + leaf signature of one argument."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, dict):
        return ("d", tuple((k, _tree_sig(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_tree_sig(v) for v in x))
    shape = getattr(x, "shape", None)
    if shape is not None and hasattr(x, "dtype"):  # numpy arrays
        return (tuple(shape), str(x.dtype))
    return (type(x),)


def _sig_of(args: Sequence[Any], kwargs: Dict[str, Any],
            static_argnums: Tuple[int, ...]) -> Tuple:
    """Hashable input signature: static args by value, tensor and array
    leaves by (shape, dtype), every other leaf by its type."""
    parts: List[Any] = []
    for i, a in enumerate(args):
        parts.append(("s", a) if i in static_argnums else _tree_sig(a))
    if kwargs:
        for k in sorted(kwargs):
            parts.append((k, _tree_sig(kwargs[k])))
    return tuple(parts)


def _structure(x: Any) -> str:
    """The argument structure as text: ``*`` a tensor leaf."""
    if isinstance(x, torch.Tensor):
        return "*"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!s}: {_structure(v)}" for k, v in x.items()) + "}"
    if isinstance(x, (list, tuple)):
        inner = ", ".join(_structure(v) for v in x)
        return f"{type(x).__name__}({inner})" if hasattr(x, "_fields") else (
            f"[{inner}]" if isinstance(x, list) else f"({inner})")
    if x is None:
        return "None"
    return type(x).__name__


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()


def _nbytes(x: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _on_cuda(x: Any) -> bool:
    return any(t.device.type == "cuda" for t in _tensors(x))


# -- the counting context ----------------------------------------------------------
_aten = torch.ops.aten
# ops that read and write no tensor data (bare allocations, metadata)
_NO_BYTES = frozenset(p for p in (
    getattr(_aten, n, None) for n in (
        "empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "_unsafe_view", "lift_fresh", "set_",
        "resize_", "detach", "alias")) if p is not None)


class _CostCounter(TorchDispatchMode):
    """Sums the product FLOPs and the bytes of every op dispatched while
    it is active (on this thread, and on autograd's threads for a backward
    started under it). :func:`kernel_cost` adds a kernel's declared cost
    and keeps the ops inside it (its plain version, on the CPU) out."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the port never compiles: without this, the handler is wrapped to
        # keep dynamo out, and its first call imports dynamo (seconds)
        return False

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.suppress = 0
        self.sampled: set = set()  # repeated_cost kinds already counted
        self.error: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.suppress:
            return out
        info = _OP_INFO.get(func)
        if info is None:
            info = _OP_INFO[func] = _op_info(func)
        formula, moves_bytes = info
        try:
            if formula is not None:
                self.flops += float(formula(*args, **(kwargs or {}), out_val=out))
            if moves_bytes:
                self.bytes += _op_bytes(args) + _op_bytes((out,))
        except Exception as e:  # noqa: BLE001 - counting never breaks a call
            self.error = f"{type(e).__name__}: {e}"[:200]
        return out


# per op overload: (its flop formula or None, whether it moves tensor data)
_OP_INFO: Dict[Any, Tuple[Any, bool]] = {}


def _op_info(func) -> Tuple[Any, bool]:
    from torch.utils.flop_counter import flop_registry

    packet = func._overloadpacket
    return flop_registry.get(packet), not func.is_view and packet not in _NO_BYTES


def _op_bytes(items) -> int:
    """Bytes of the tensors among an op's arguments or outputs (one level
    of list nesting, as aten's signatures have)."""
    n = 0
    for a in items:
        if isinstance(a, torch.Tensor):
            n += a.numel() * a.element_size()
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    n += b.numel() * b.element_size()
    return n


@contextlib.contextmanager
def kernel_cost(flops: float, nbytes: float) -> Iterator[None]:
    """A hand-written kernel's launch (or its plain version's run) with its
    declared cost: under a counting context the ``flops`` and ``nbytes``
    are added and the ops inside are not counted; otherwise nothing
    happens. Adds no work on the device and no synchronisation."""
    counters = [m for m in _get_current_dispatch_mode_stack()
                if isinstance(m, _CostCounter)]
    for c in counters:
        c.flops += float(flops)
        c.bytes += float(nbytes)
        c.suppress += 1
    try:
        yield
    finally:
        for c in counters:
            c.suppress -= 1


@contextlib.contextmanager
def repeated_cost(kind: Any, count: int) -> Iterator[None]:
    """A block that a program runs ``count`` times with the same work each
    time (a local step of a given kind): under a counting context its ops
    are counted on its first run and that cost is taken ``count`` times; its
    other runs leave the counting context (no dispatch through it, so a
    first call costs one iteration of counting, not all of them).
    Otherwise nothing happens."""
    top = _get_current_dispatch_mode()
    if not isinstance(top, _CostCounter):
        yield
        return
    if kind in top.sampled:
        with _pop_mode_temporarily():
            yield
        return
    top.sampled.add(kind)
    flops, nbytes = top.flops, top.bytes
    try:
        yield
    finally:
        top.flops += (top.flops - flops) * (count - 1)
        top.bytes += (top.bytes - nbytes) * (count - 1)


class CatalogedProgram:
    """Callable wrapper that measures and counts one program's calls."""

    def __init__(self, catalog: "ProgramCatalog", name: str, fn,
                 static_argnums: Tuple[int, ...] = (),
                 multi_shape: bool = False):
        self._catalog = catalog
        self._name = name
        self._fn = fn
        self._static = tuple(int(i) for i in static_argnums)
        self.record = catalog._record(name, multi_shape=multi_shape)

    @property
    def name(self) -> str:
        return self._name

    def _note_call(self, variant: Optional[_Variant]) -> None:
        rec = self.record
        from fedml_tpu_torch.telemetry import spans as _spans

        span = _spans._current.get()
        phase = _phase_of(span.name if span is not None else None,
                          self._catalog._phase_memo)
        cat = self._catalog
        with cat._rate_lock:
            rec.calls += 1
            if rec.first_call_ts is None:
                rec.first_call_ts = time.time()
            rec.phase_calls[phase] = rec.phase_calls.get(phase, 0) + 1
            if variant is not None:
                cat._flops_total += variant.flops
                cat._bytes_total += variant.bytes_accessed

    def __call__(self, *args, **kwargs):
        cat = self._catalog
        if not cat.enabled or _PROGRAM_VAR.get() is not None:
            return self._fn(*args, **kwargs)
        token = _PROGRAM_VAR.set(self._name)
        try:
            try:
                key = (self._name, _sig_of(args, kwargs, self._static))
                variant = cat._variants.get(key)
            except TypeError:  # an unhashable static argument
                self.record.fallback_calls += 1
                out = self._fn(*args, **kwargs)
                self._note_call(None)
                return out
            if variant is None:
                out, variant = self._first_call(key, args, kwargs)
            else:
                out = self._fn(*args, **kwargs)
            self._note_call(variant)
            return out
        finally:
            _PROGRAM_VAR.reset(token)

    def _first_call(self, key: Tuple, args: Sequence[Any],
                    kwargs: Dict[str, Any]):
        rec = self.record
        cuda = _on_cuda((args, kwargs)) and torch.cuda.is_available()
        if cuda:
            a0 = torch.cuda.memory_allocated()
            p0 = torch.cuda.max_memory_allocated()
        counter = _CostCounter()
        t0 = time.perf_counter()
        with counter:
            out = self._fn(*args, **kwargs)
        wall_ms = (time.perf_counter() - t0) * 1e3
        variant = _Variant(counter.flops, counter.bytes)
        out_bytes = _nbytes(out)
        peak = temp = 0.0
        if cuda:
            self._catalog._cuda_seen = True
            a1 = torch.cuda.memory_allocated()
            p1 = torch.cuda.max_memory_allocated()
            peak = float(p1 if p1 > p0 else max(a0, a1))
            temp = max(peak - a1, 0.0)
        with self._catalog._lock:
            self._catalog._variants[key] = variant
            rec.compile_wall_ms += wall_ms
            rec.n_signatures += 1
            rec.argument_bytes = _nbytes((args, kwargs))
            rec.output_bytes = out_bytes
            rec.temp_bytes = temp
            rec.peak_hbm_bytes = max(rec.peak_hbm_bytes, peak)
            rec.treedef = _structure((tuple(args), kwargs))[:400]
            if counter.error is not None:
                rec.analysis_error = counter.error
            if variant.flops or variant.bytes_accessed:
                rec.flops = variant.flops
                rec.bytes_accessed = variant.bytes_accessed
            if rec.n_signatures > 1:
                get_registry().counter(
                    "profile/recompiles",
                    labels={"program": self._name}).inc()
        return out, variant


class ProgramCatalog:
    """Process-wide registry of cataloged programs."""

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = _enabled_from_env() if enabled is None else enabled
        self._records: Dict[str, ProgramRecord] = {}
        # measured costs by (program name, input signature): every wrapper
        # of a name shares them (each silo's trainer wraps its own local
        # step), so a signature is counted once in the catalog's life
        self._variants: Dict[Tuple[str, Tuple], _Variant] = {}
        # held weakly: a program wraps its owner's bound method (a trainer's
        # step, an engine's decode), and the catalog must not keep the owner
        # and its model alive after the run that made them
        self._programs: "weakref.WeakValueDictionary[str, CatalogedProgram]" = (
            weakref.WeakValueDictionary())
        self._lock = threading.Lock()
        self._rate_lock = threading.Lock()  # per-call counters/totals
        self._phase_memo: Dict[str, str] = {}
        self._flops_total = 0.0
        self._bytes_total = 0.0
        self._cuda_seen = False
        self.uncataloged_compiles = 0
        self.uncataloged_compile_ms = 0.0
        self._pump_t0: Optional[float] = None
        self._pump_flops = 0.0

    # -- registration -----------------------------------------------------
    def _record(self, name: str, multi_shape: bool = False) -> ProgramRecord:
        with self._lock:
            rec = self._records.get(name)
            if rec is None:
                rec = self._records[name] = ProgramRecord(
                    name, multi_shape=multi_shape)
            return rec

    def wrap(self, name: str, fn, static_argnums: Tuple[int, ...] = (),
             multi_shape: bool = False) -> CatalogedProgram:
        prog = CatalogedProgram(self, name, fn, static_argnums=static_argnums,
                                multi_shape=multi_shape)
        with self._lock:
            self._programs[name] = prog
        return prog

    # -- kernel-build attribution (ops/_build.py) ------------------------------
    def on_compile_event(self, ms: float) -> None:
        name = _PROGRAM_VAR.get()
        if name is None:
            self.uncataloged_compiles += 1
            self.uncataloged_compile_ms += ms
            return
        rec = self._record(name)
        rec.compile_events += 1
        rec.compile_ms += ms

    # -- reads -------------------------------------------------------------
    def records(self) -> List[ProgramRecord]:
        with self._lock:
            return sorted(self._records.values(), key=lambda r: r.name)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.records()]

    # -- sinks -------------------------------------------------------------
    def flush_jsonl(self, run_dir: str,
                    filename: str = "programs.jsonl") -> Optional[str]:
        """Rewrite the per-run program catalog snapshot (one line per
        program — a snapshot, not an append stream). Programs that never
        ran in this catalog's lifetime are not part of this run."""
        rows = [r for r in self.snapshot()
                if r["calls"] or r["compile_events"] or r["n_signatures"]]
        if not rows:
            return None
        if self._cuda_seen:
            device_kind, platform = torch.cuda.get_device_name(0), "gpu"
        else:
            device_kind = platform = "cpu"
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, filename)
        tmp = path + ".tmp"
        ts = time.time()
        with open(tmp, "w") as f:
            for row in rows:
                f.write(json.dumps({
                    "ts": ts, "device_kind": device_kind,
                    "platform": platform, **row}, default=str) + "\n")
        os.replace(tmp, path)
        return path

    def pump_gauges(self) -> None:
        """Land the catalog state in ``profile/*`` registry gauges."""
        from fedml_tpu_torch.telemetry.profiling.roofline import (
            arithmetic_intensity,
            device_peaks,
            ridge_point,
        )

        reg = get_registry()
        records = self.records()
        reg.gauge("profile/programs").set(float(len(records)))
        reg.gauge("profile/uncataloged_compiles").set(
            float(self.uncataloged_compiles))
        for rec in records:
            labels = {"program": rec.name}
            reg.gauge("profile/flops", labels=labels).set(rec.flops)
            reg.gauge("profile/bytes_accessed", labels=labels).set(
                rec.bytes_accessed)
            reg.gauge("profile/peak_hbm_bytes", labels=labels).set(
                rec.peak_hbm_bytes)
            reg.gauge("profile/compile_ms", labels=labels).set(
                rec.compile_ms)
            reg.gauge("profile/calls", labels=labels).set(float(rec.calls))
        # rolling achieved rate since the last pump → live MFU + roofline
        now = time.perf_counter()
        peaks = device_peaks()
        ridge = ridge_point(peaks)
        ai = arithmetic_intensity(self._flops_total, self._bytes_total)
        if ai is not None:
            reg.gauge("profile/ai").set(ai)
            reg.gauge("profile/ridge").set(ridge)
            reg.gauge("profile/hbm_bound").set(1.0 if ai < ridge else 0.0)
        if self._pump_t0 is not None:
            dt = now - self._pump_t0
            dflops = self._flops_total - self._pump_flops
            if dt > 1e-3 and dflops > 0:
                rate = dflops / dt
                reg.gauge("profile/flops_per_s").set(rate)
                if peaks[0]:
                    reg.gauge("profile/mfu").set(rate / peaks[0])
        self._pump_t0 = now
        self._pump_flops = self._flops_total


_catalog: Optional[ProgramCatalog] = None
_catalog_lock = threading.Lock()


def get_catalog() -> ProgramCatalog:
    global _catalog
    with _catalog_lock:
        if _catalog is None:
            _catalog = ProgramCatalog()
        return _catalog


def reset_catalog() -> None:
    """Drop the process-global catalog (test isolation; reads
    ``FEDML_PROFILE`` again). Already-wrapped programs re-home their
    accounting into the fresh catalog, which measures each variant anew."""
    global _catalog
    with _catalog_lock:
        old, _catalog = _catalog, ProgramCatalog()
        if old is not None:
            for name, prog in list(old._programs.items()):
                prog._catalog = _catalog
                prog.record = _catalog._record(
                    name, multi_shape=prog.record.multi_shape)
                _catalog._programs[name] = prog


def wrap_program(name: str, fn, static_argnums: Tuple[int, ...] = (),
                 multi_shape: bool = False) -> CatalogedProgram:
    """Register ``fn`` in the process catalog under ``name`` — the
    reference's ``wrap_jit``, named after what it wraps: the port has no
    jit, so the program is the eager function itself.

    ``static_argnums`` are keyed by value, as the reference's static args.
    ``multi_shape=True`` marks programs that legitimately run one variant
    per input shape, so recompile verdicts skip them.
    """
    return get_catalog().wrap(name, fn, static_argnums=static_argnums,
                              multi_shape=multi_shape)


def pump_profile_gauges() -> None:
    """Refresh ``profile/*`` gauges from the current catalog (a no-op when
    nothing is registered) — called from the device-stats sampler so every
    phase sample also refreshes the live MFU and roofline."""
    cat = _catalog
    if cat is not None and cat._records:
        cat.pump_gauges()
