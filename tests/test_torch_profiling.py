"""The port's tracing and timing helpers (``torchmdnet_tpu_torch/profiling.py``)
on the CPU, with the device named explicitly: the JAX module's public names,
``benchmark``, ``benchmark_pipelined`` and ``device_ms_per_iter`` on a
chained carry, and ``trace`` read back by ``trace_summary``."""

import json
import time

import pytest
import torch

from torchmdnet_tpu_torch import profiling

JAX_NAMES = ("trace", "scope", "force", "benchmark", "device_ms_per_iter", "trace_summary", "benchmark_pipelined")


def test_public_names_are_the_jax_modules():
    assert all(callable(getattr(profiling, name)) for name in JAX_NAMES)


def _slow_add(x, ms=2.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ms / 1e3:
        pass
    return x + 1


@pytest.mark.parametrize("bench", [profiling.benchmark, profiling.benchmark_pipelined])
def test_benchmarks_time_the_call(bench):
    out = bench(_slow_add, torch.zeros(4), warmup=1, iters=5)
    assert out["iters"] == 5 and 2.0 <= out["mean_ms"] < 200.0
    if bench is profiling.benchmark:
        assert out["min_ms"] <= out["median_ms"] <= max(out["mean_ms"], out["median_ms"])


def test_device_ms_per_iter_differences_a_chained_carry():
    calls = []

    def step(carry, eps):
        calls.append(1)
        return _slow_add(carry + eps, ms=1.0)

    ms = profiling.device_ms_per_iter(step, torch.zeros(8), k_lo=1, k_hi=4, reps=2, device="cpu")
    assert 1.0 <= ms < 50.0
    # one warm-up window at k_lo, then reps windows at each k
    assert len(calls) == 1 + 2 * (1 + 4)


def test_trace_then_summary_finds_the_op(tmp_path):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiling.trace(str(tmp_path), device="cpu"):
        for _ in range(3):
            with profiling.scope("matmul_scope"):
                profiling.force(torch.mm(a, b))
    rows = profiling.trace_summary(str(tmp_path), top=5, iters=3, device="cpu")
    by_name = {r["name"]: r for r in rows}
    assert by_name["aten::mm"]["count"] == 1 and by_name["aten::mm"]["ms"] > 0.0
    assert all("gbps" not in r for r in rows)
    (path,) = tmp_path.glob("*.pt.trace.json")
    scopes = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("name") == "matmul_scope"]
    assert len(scopes) == 3
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)


def test_trace_summary_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.trace_summary(str(tmp_path), device="cpu")
