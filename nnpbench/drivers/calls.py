"""An MD engine's calls into the port: one ``External.calculate`` a timed
step, on the positions the engine hands it, with the periodic box.

The engine here is the benchmark (``Walk``): atoms at protein density with
an excluded volume (``inputs.systems.lattice_system``), each call moved by
an Ornstein-Uhlenbeck step about its place, ``step_A`` A a coordinate (a
1 fs step at 300 K moves a hydrogen about 0.016 A a coordinate) with an
amplitude of ``vibration_A``, drawn on the card from the seed.  The
positions do not depend on the model, so every call holds the same pairs,
give or take a few, whatever the seeded weights would make of them.
Every call rebuilds the neighbor list (cell list and #6) and runs the
fused forward and backward (#1, #2) for the forces.

Set-up makes the system and the weights (``reference.weights``) from the
seed, builds the Potential and ``External`` (which probes the cell list's
sizes on its first call) and takes the warm-up calls.  The check compares
the forces the timed path returned at two calls of the window, one drawn
from the seed among its first ``checked_calls_within`` calls and the last,
with the plain float32 reference's at the same positions (its own
all-pairs list, minimum image).  Over both calls:

- ``force_gap``: the largest over atoms of |F - F_ref| over (the atom's
  |F_ref| + the rms over atoms of |F_ref|);
- ``force_rms``: the rms over atoms of |F - F_ref| over the rms of |F_ref|,
  the larger of the two calls'.
"""

import math

import torch

from nnpbench.inputs import systems
from nnpbench.reference import et as ref
from nnpbench.reference import weights


class Walk:
    """The engine's positions: ``sites`` (the lattice system, sorted in
    space) plus a displacement that ``next()`` moves by one
    Ornstein-Uhlenbeck step, from a generator on ``device`` seeded from
    the seed."""

    def __init__(self, traffic, seed, device):
        t = traffic
        self.z_np, pos, self.side = systems.sorted_lattice(t["n_atoms"], t["jitter"], seed, cell=t["sort_cell"])
        self.z = torch.as_tensor(self.z_np, device=device).long()
        self.sites = torch.as_tensor(pos, device=device)
        amplitude, step = t["vibration_A"], t["step_A"]
        self.keep = 1.0 - step ** 2 / (2.0 * amplitude ** 2)  # the increment's spread is ``step``
        self.kick = amplitude * math.sqrt(1.0 - self.keep ** 2)
        self.gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63 + 1)
        self.u = amplitude * self._normal()
        self.pos = self.sites + self.u

    def _normal(self):
        return torch.randn(self.sites.shape, generator=self.gen, device=self.sites.device)

    def next(self):
        self.u = self.keep * self.u + self.kick * self._normal()
        self.pos = self.sites + self.u
        return self.pos


class Runner:
    def __init__(self, cell):
        from torchmdnet_tpu_torch import create_model
        from torchmdnet_tpu_torch.calculators import External

        t = cell.traffic
        dev = cell.device
        self.cell = cell
        self.walk = Walk(t, cell.seed, dev)
        self.z = self.walk.z
        args = cell.model_args
        std = cell.config.get("energy_std", 1.0)
        self.weights = weights.fill(ref.build(args, dev, std=std), cell.seed).state_dict()
        model = create_model(args, std=std, device=dev)
        model.module.load_state_dict(self.weights)
        self.external = External((model, None), self.walk.z_np[None, :], device=dev, use_box=True)
        self.box = torch.eye(3, device=dev) * self.walk.side  # the program's (3, 3) rows a, b, c
        self.keep_at = cell.seed % t["checked_calls_within"]
        self.calls = 0
        self.kept = []
        for _ in range(t["warmup_calls"]):
            self._call()
        self.calls = 0
        self.kept = []
        with torch.no_grad():
            g = ref.graph_of(self.walk.pos, torch.zeros(len(self.z), dtype=torch.long, device=dev), 1,
                             args["cutoff_lower"], args["cutoff_upper"], self.walk.side)
        self.pairs = int(g.i.numel())
        self.pairs_ne = self.pairs - len(self.z)
        self.last = None

    def _call(self):
        pos = self.walk.next()
        _, forces = self.external.calculate(pos, self.box)
        if self.calls == self.keep_at:
            self.kept.append((pos, forces[0]))
        self.last = (pos, forces[0])
        self.calls += 1

    def step(self):
        self._call()
        return 1

    def counters(self):
        from torchmdnet_tpu_torch.ops.kernels import et_message, select_topk

        return {"et_fwd": et_message.run_fwd.launches, "et_bwd": et_message.run_bwd.launches,
                "select_topk": select_topk.select_topk.launches}

    def work(self, steps):
        """Pairs and atoms of a call, counted at the set-up positions (the
        atoms stay near their places)."""
        return {"kind": "md", "args": self.cell.model_args, "atoms": len(self.z), "pairs": self.pairs,
                "pairs_ne": self.pairs_ne, "steps": steps}

    def finish(self):
        out = dict(z=self.z, side=self.walk.side, calls=self.kept + [self.last], weights=self.weights)
        self.external = None
        return out


def setup(cell):
    return Runner(cell)


def gaps(c, truth):
    """The check's numbers for the calls ``c["calls"]`` ((positions, forces)
    each) against the reference's forces ``truth`` at the same positions."""
    worst, rms = 0.0, 0.0
    for (_, f), f_ref in zip(c["calls"], truth):
        size = f_ref.norm(dim=1)
        size_rms = size.pow(2).mean().sqrt()
        miss = (f - f_ref).norm(dim=1)
        worst = max(worst, float((miss / (size + size_rms)).max()))
        rms = max(rms, float(miss.pow(2).mean().sqrt() / size_rms))
    return {"force_gap": worst, "force_rms": rms}


def truth_of(cell, c, edge=None, node=None):
    """The reference's forces at the positions of ``c["calls"]``: float32,
    or rounded through ``edge`` and ``node`` (``ref.loaded``)."""
    with ref.exact_fp32():
        model = ref.loaded(cell.model_args, cell.device, c["weights"], cell.config.get("energy_std", 1.0),
                           edge, node)
        return [ref.system_forces(model, c["z"], pos, c["side"]) for pos, _ in c["calls"]]


def check(cell, c):
    return gaps(c, truth_of(cell, c))
