"""Cells of the benchmark cut to a size a CPU test holds: the files' own
configuration and traffic with a 2 x 32 model and a few hundred atoms, on
the CPU (the port's fused kernels run their plain versions there)."""

import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from nnpbench import harness  # noqa: E402

TINY_MODEL = dict(embedding_dimension=32, num_layers=2, num_rbf=16, num_heads=4)
TINY_ATOMS = 317  # a periodic cube of 15 A at the traffic's density

torch.set_num_threads(2)


def bench(root=ROOT):
    return harness.load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name, seed=2147483659, seconds=1.0, root=ROOT, widths="tiny", n_atoms=TINY_ATOMS):
    """The cell at a CPU size: ``n_atoms`` atoms at its traffic's density,
    its model cut to 2 x 32 (``widths="tiny"``) or at the configuration's
    own widths."""
    entry = {w["name"]: w for w in bench(root)["workloads"]}[name]
    workload, traffic, config = harness.load_cell_files(root, entry)
    if widths == "tiny":
        config = dict(config, model=dict(config["model"], **TINY_MODEL))
    traffic = dict(traffic, n_atoms=n_atoms)
    return harness.Cell(name=name, seed=seed, seconds=seconds, trace=False, workload=workload, traffic=traffic,
                        config=config, chips=entry["chips"], device=torch.device("cpu"),
                        tmpdir=tempfile.mkdtemp(prefix="nnpbench-test-"))


def run(name, **kw):
    return harness.run(cell(name, **kw), bench(), ROOT, time.perf_counter())
