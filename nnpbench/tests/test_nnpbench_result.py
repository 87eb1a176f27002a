"""The result line's shape, the import guard, and the run's refusal without
a card."""

import json
import os
import subprocess
import sys
import types

import pytest

from nnpbench.tests import tiny
from nnpbench import harness


@pytest.fixture(scope="module")
def md_result():
    return tiny.run("et-md-calls")


def test_last_line_shape(md_result, capsys):
    assert harness.emit(md_result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in harness.cell_metrics(tiny.bench(), "et-md-calls")[0]}
    assert set(line["metrics"]) <= names and "md_ms_per_step" in line["metrics"] and "setup_s" in line["metrics"]
    for row in line["metrics"].values():
        assert set(row) == {"value", "unit"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {k}" for k in line["checks"]]
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"}


def test_guard_passes_the_port_and_names_jax(monkeypatch):
    import torchmdnet_tpu_torch  # noqa: F401  (the port's name begins with the JAX package's)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "torchmdnet_tpu.models", types.ModuleType("torchmdnet_tpu.models"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "torchmdnet_tpu"]


def test_guard_refuses_the_result(md_result, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert harness.emit(md_result) == 3
    out, err = capsys.readouterr()
    assert out == "" and "flax" in err


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run([sys.executable, os.path.join(tiny.ROOT, "nnpbench", "run.py"), "--workload", "et-md-calls",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tiny.ROOT)
    assert p.returncode != 0 and p.stdout == ""
