"""Tracing and timing (counterpart of torchmdnet_tpu/profiling.py).

The JAX package's names, on PyTorch and CUDA:

- ``trace(log_dir)``: a ``torch.profiler`` capture (CPU and CUDA activity)
  written to ``log_dir`` as a Chrome/Perfetto trace file;
- ``scope(name)``: a named region, ``record_function`` plus an NVTX range on
  the GPU;
- ``force(out)``: waits for the devices of every tensor in ``out``;
- ``benchmark`` (per-call latency, each call waited for) and
  ``benchmark_pipelined`` (every call enqueued, then waited for);
- ``device_ms_per_iter``: device time per iteration of a step whose carry
  chains one iteration into the next, timed between CUDA events and
  differenced between two iteration counts so the launch overhead cancels;
- ``trace_summary(log_dir)``: the device kernels of a ``trace`` capture by
  total time, with their count and ms per iteration.

and the timers of the port's checks and tools (``chip_smoke.py``,
``tools/time_bwd.py``, ``tools/time_external.py``): ``event_ms`` (CUDA-event
window, L2 flushed), ``host_ms`` (host clock around a synchronised call),
``enqueue_ms`` (host clock, no synchronise), ``kernel_profile``
(``torch.profiler``'s device time by kernel name) and ``device_ms`` (device
time alone of one call).

Every entry point runs on the GPU unless ``device="cpu"`` is asked for, as
the tests do; on the CPU the host clock stands in for CUDA events, and a
trace holds CPU operators instead of kernels.
"""

import contextlib
import glob
import json
import os
import statistics
import time
from typing import Callable, Dict

import torch

# what ``flush.zero_()`` runs on the card, left out of ``device_ms``
FLUSH_KERNELS = ("FillFunctor", "Memset")


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)
    elif hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            yield from _tensors(getattr(out, name))


def force(out):
    """Wait until every tensor in ``out`` (nested lists, tuples, dicts,
    dataclasses such as ``AtomicBatch``) is computed: each CUDA device that
    holds one is synchronised.  Returns ``out`` unchanged."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out


def _sync(device):
    if _is_cuda(device):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity on
    the GPU) of the block into ``log_dir``: a ``*.pt.trace.json`` file that
    Perfetto or ``chrome://tracing`` opens and ``trace_summary`` reads.

    >>> with trace("/tmp/torch-trace"):
    ...     force(model.energy_and_forces(batch))
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _is_cuda(device) else [])
    os.makedirs(log_dir, exist_ok=True)
    _sync(device)
    with profile(activities=activities) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def scope(name: str):
    """A named region in ``trace`` captures (``record_function``) and, with a
    GPU, in NVTX."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def benchmark(fn: Callable, *args, warmup: int = 3, iters: int = 30, device=None) -> Dict[str, float]:
    """Per-call latency of ``fn(*args)`` on the host clock, each call waited
    for: its outputs (``force``) and, where ``device`` is named, all the work
    queued on that device.  What a caller that needs each result sees (an MD
    engine calling the calculator once per step)."""

    def wait(out):
        force(out)
        if device is not None:
            _sync(device)

    out = None
    for _ in range(warmup):
        out = fn(*args)
    wait(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        wait(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"mean_ms": sum(times) / len(times) * 1e3, "min_ms": min(times) * 1e3,
            "median_ms": statistics.median(times) * 1e3, "iters": iters}


def benchmark_pipelined(fn: Callable, *args, warmup: int = 3, iters: int = 30) -> Dict[str, float]:
    """Throughput of ``fn(*args)``: ``iters`` calls enqueued back to back,
    then every output waited for; mean ms per call on the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    force(outs)
    return {"mean_ms": (time.perf_counter() - t0) / iters * 1e3, "iters": iters}


def device_ms_per_iter(step_fn: Callable, init_carry, k_lo: int = 2, k_hi: int = 22, reps: int = 3,
                       device="cuda") -> float:
    """Device time per iteration of ``step_fn(carry, eps) -> carry``.

    The carry chains each iteration's output into the next input (``eps`` is
    a zero scalar on ``device`` that the step may mix in, so that nothing of
    the chain is constant); k iterations run between two CUDA events, and
    the best of ``reps`` windows at ``k_hi`` less the best at ``k_lo``,
    over ``k_hi - k_lo``, is the time of one iteration with the launch
    overhead of a window cancelled.  The step must consume every output to
    be measured.  On the CPU the host clock stands in for the events."""
    eps = torch.zeros((), device=device)

    def window(k):
        carry = init_carry
        if _is_cuda(device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                carry = step_fn(carry, eps)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        for _ in range(k):
            carry = step_fn(carry, eps)
        force(carry)
        return 1e3 * (time.perf_counter() - t0)

    window(k_lo)  # first calls: kernel builds, allocator growth
    force(init_carry)
    best = {k: min(window(k) for _ in range(reps)) for k in (k_lo, k_hi)}
    return (best[k_hi] - best[k_lo]) / (k_hi - k_lo)


def _by_name(events):
    """{name: [total ms, count]} of (name, ms) pairs: the one aggregation of
    profiler events, ``trace_summary``'s and ``kernel_profile``'s."""
    agg: Dict[str, list] = {}
    for name, ms in events:
        row = agg.setdefault(name, [0.0, 0])
        row[0] += ms
        row[1] += 1
    return agg


def trace_summary(log_dir: str, top: int = 25, iters: int = 1, device="cuda"):
    """The device kernels (on the CPU: the operators) of the newest
    ``trace`` capture under ``log_dir`` by total time: a list of dicts
    {name, ms, count} sorted by ``ms``, both per ``iters``; prints the top
    ``top``.  A CUDA trace records no bytes moved, so no rate is given."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    with open(paths[-1]) as f:
        data = json.load(f)
    category = "kernel" if _is_cuda(device) else "cpu_op"
    agg = _by_name((e["name"], float(e.get("dur", 0.0)) / 1e3 / iters) for e in data.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") == category)
    rows = sorted(({"name": name, "ms": ms, "count": count / iters} for name, (ms, count) in agg.items()),
                  key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in rows)
    print(f"{'device' if category == 'kernel' else 'cpu'} total: {total:.3f} ms/iter over {len(rows)} "
          f"{'kernels' if category == 'kernel' else 'operators'}")
    for r in rows[:top]:
        print(f"{r['ms']:9.3f} ms x{r['count']:<6g} {r['name'][:120]}")
    return rows


# --- the timers of the port's checks and tools ------------------------------


def event_ms(fn, reps=20, warmup=3, flush=None):
    """Median over ``reps`` calls of the CUDA-event window around ``fn()``,
    the L2 flushed before each (``flush``: a tensor larger than the L2,
    zeroed)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=20, warmup=3):
    """Median over ``reps`` calls of host-clock time, each ended by a
    synchronise of the card (``benchmark``'s median)."""
    return benchmark(fn, warmup=warmup, iters=reps, device="cuda")["median_ms"]


def enqueue_ms(fn, reps=200, warmup=10):
    """Median over ``reps`` calls of host-clock time with no synchronise:
    what the host takes to enqueue one call (the card runs behind it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_profile(fn, reps, names):
    """Run ``fn`` ``reps`` times under torch.profiler's CUDA activity: (wall
    ms per rep on the host clock, device busy ms per rep, {name: device ms
    per rep of the kernels whose names contain it}, the other kernels' ms per
    rep, their launches per rep, {name: launches per rep})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    groups, counts = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    other, launches = 0.0, 0
    agg = _by_name((ev.name, ev.device_time / 1e3 / reps) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    for name, (ms, count) in agg.items():
        key = next((k for k in groups if k in name), None)
        if key is None:
            other += ms
            launches += count
        else:
            groups[key] += ms
            counts[key] += count
    busy = sum(groups.values()) + other
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    return wall, busy, groups, other, launches / reps, {k: c / reps for k, c in counts.items()}


def device_ms(fn, flush, reps=20):
    """Device time alone of one call: ``kernel_profile``'s device time of
    the kernels ``fn`` runs, mean of ``reps`` calls with the L2 flushed
    before each, the flush's own kernels left out by name."""
    _, _, groups, other, _, _ = kernel_profile(lambda: (flush.zero_(), fn()), reps, FLUSH_KERNELS)
    if not (sum(groups.values()) > 0.0 and other > 0.0):
        raise AssertionError(f"the profiler did not tell the flush from the call: flush {groups}, call {other} ms")
    return other
