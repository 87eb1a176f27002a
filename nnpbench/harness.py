"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result line.

Everything a cell is lives in files that the run finds by name:

- ``nnpbench/workloads/<cell>.json``: the driver and the limits of the
  cell's check;
- ``nnpbench/traffic/<traffic>.json``: the traffic's parameters, which the
  driver's generator reads;
- ``nnpbench/configs/<config>.json``: the model's arguments, its source,
  what was changed from it and what was assumed;
- ``nnpbench/drivers/<driver>.py``: ``setup(cell)`` returns a runner whose
  ``step()`` is one timed call into the program (returning the items it
  completed), ``work()`` the work the window did, ``counters()`` the
  program's counters and ``finish()`` what the check compares;
  ``check(cell, captured)`` returns {number: value};
- ``nnpbench/end_to_end/<metric>.py`` and ``nnpbench/layer_metrics/<metric>.py``:
  ``read(ctx)`` returns the metric's value, or None where the run has
  nothing for it to read.

``BENCHMARK.json`` says which metrics a cell reports.
"""

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from nnpbench import trace as tr

PROGRAM = "torchmdnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "torchmdnet_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    workload: Dict[str, Any]  # the cell's file: its driver and the limits of its check
    traffic: Dict[str, Any]
    config: Dict[str, Any]
    chips: int
    device: torch.device
    tmpdir: str

    @property
    def model_args(self):
        return dict(self.config["model"])


class Spans:
    """The benchmark's own host spans around its calls into the program
    (``with spans("step"): ...``): durations in seconds by name, and a
    profiler annotation of the same name in the traced run."""

    def __init__(self, annotate=False):
        self.annotate = annotate
        self.seconds: Dict[str, List[float]] = {}

    def __call__(self, name):
        return _Span(self, name)


class _Span:
    def __init__(self, spans, name):
        self.spans, self.name = spans, name
        self.rf = tr.annotate("nnpbench." + name) if spans.annotate else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        self.spans.seconds.setdefault(self.name, []).append(time.perf_counter() - self.t)
        if self.rf is not None:
            self.rf.__exit__(*exc)


@dataclasses.dataclass
class Context:
    """What a metric's reader takes."""

    cell: Cell
    steps: int
    items: int
    window_s: float  # host clock, first step to the final synchronise
    step_ms: List[float]  # CUDA-event intervals, one per step
    peak_bytes: int  # over the window
    setup_s: float
    spans: Dict[str, List[float]]
    counters: Dict[str, float]  # the program's counters, their change over the window
    work: Dict[str, Any]
    peaks: Dict[str, float]
    trace: Optional[tr.Trace] = None


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell_files(root, entry):
    """(cell file, traffic file, configuration file) of a ``workloads`` entry
    of BENCHMARK.json, each found by its name there."""
    def load(kind, name):
        return load_json(os.path.join(root, "nnpbench", kind, name + ".json"))

    return load("workloads", entry["name"]), load("traffic", entry["traffic"]), load("configs", entry["config"])


def reader(root, kind, name):
    """The ``read`` function of ``nnpbench/<kind>/<name>.py``."""
    path = os.path.join(root, "nnpbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"nnpbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench, cell):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def peaks_of(root, kind):
    table = load_json(os.path.join(root, "nnpbench", "peaks.json"))
    for key, row in table.items():
        if kind.startswith(key):
            return row
    return None


def forbidden_modules():
    """The forbidden top-level modules loaded in this process, compared by
    whole top-level names (the program's own name begins with one)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def measure(cell, runner):
    """The measured window: ``runner.step()`` until ``cell.seconds`` have
    passed on the host clock, a CUDA event after each step, then one
    synchronise.  Returns (steps, items, window_s, step_ms, peak, trace,
    the host clock at the window's start)."""
    spans = runner.spans
    dev = cell.device
    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    prof = tr.profiler() if cell.trace else None
    if prof is not None:
        prof.__enter__()
    events, items = [], 0
    ann = tr.annotate(tr.WINDOW) if cell.trace else None
    if ann is not None:
        ann.__enter__()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    t_start = time.perf_counter()
    while True:
        with spans("step"):
            items += runner.step()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            events.append(time.perf_counter())
        if time.perf_counter() - t_start >= cell.seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_start
    if ann is not None:
        ann.__exit__(None, None, None)
    if prof is not None:
        prof.__exit__(None, None, None)
    if cuda:
        marks = [start] + events
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        marks = [t_start] + events
        step_ms = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
        peak = 0
    trace = tr.read(prof, cell.tmpdir) if prof is not None else None
    return len(events), items, window_s, step_ms, peak, trace, t_start


def check_numbers(cell, numbers):
    """{name: {"value", "limit"}} and whether every number is within its limit."""
    limits = cell.workload["limits"]
    if set(numbers) != set(limits):
        raise RuntimeError(f"the check gave {sorted(numbers)}, the cell's limits name {sorted(limits)}")
    out = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in out.values())
    return out, ok


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def log(text):
    print(f"nnpbench: {text}", file=sys.stderr, flush=True)


def run(cell, bench, root, t_process):
    """One run of ``cell``: the result line's dict.  ``t_process`` is the
    host clock at process start, from which set-up is timed."""
    driver = importlib.import_module(f"nnpbench.drivers.{cell.workload['driver']}")
    e2e, layer = cell_metrics(bench, cell.name)
    runner = driver.setup(cell)
    runner.spans = Spans(annotate=cell.trace)
    counters0 = runner.counters()
    process_peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    log(f"set-up done at {time.perf_counter() - t_process:.2f} s")
    steps, items, window_s, step_ms, peak, trace, t_start = measure(cell, runner)
    setup_s = t_start - t_process
    log(f"window: {steps} steps in {window_s:.3f} s; trace read by {time.perf_counter() - t_process:.2f} s")
    counters1 = runner.counters()
    counters = {k: counters1[k] - counters0[k] for k in counters0}
    work = runner.work(steps)
    spans = runner.spans.seconds
    captured = runner.finish()
    del runner
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check(cell, captured)
    del captured
    log(f"check took {time.perf_counter() - t_check:.2f} s")
    checks, ok = check_numbers(cell, numbers)
    kind = torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda" else "cpu"
    ctx = Context(cell=cell, steps=steps, items=items, window_s=window_s, step_ms=step_ms, peak_bytes=peak,
                  setup_s=setup_s, spans=spans, counters=counters, work=work, peaks=peaks_of(root, kind),
                  trace=trace)
    metrics = {}
    for m in (layer if cell.trace else e2e):
        value = reader(root, "layer_metrics" if cell.trace else "end_to_end", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": int(max(process_peak, peak))}
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
    if cell.device.type == "cuda":
        device["power_limit"] = power_limit()
    result = {"correct": bool(ok), "attempted": steps, "failed": 0, "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    return result


def main(args, t_process, root):
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in entries:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(entries)}", file=sys.stderr)
        return 2
    entry = entries[args.workload]
    workload, traffic, config = load_cell_files(root, entry)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    program = importlib.import_module(PROGRAM)
    where = os.path.dirname(os.path.abspath(program.__file__))
    if os.path.dirname(where) != root:
        print(f"{PROGRAM} was imported from {where}, not from the checkout {root}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="nnpbench-") as tmpdir:
        # any whole number: numpy's generators take non-negative seeds
        cell = Cell(name=args.workload, seed=int(args.seed) % 2 ** 63, seconds=float(args.seconds), trace=bool(args.trace),
                    workload=workload, traffic=traffic, config=config, chips=chips, device=torch.device("cuda", 0),
                    tmpdir=tmpdir)
        result = run(cell, bench, root, t_process)
    return emit(result)


def emit(result):
    """Print the result: each number the check compared beside its limit as
    the last lines of standard error, the result as the last line of
    standard output; none where a forbidden module was loaded (returns 3)."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
