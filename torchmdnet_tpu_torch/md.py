"""Molecular dynamics on a potential (counterpart of torchmdnet_tpu/md.py).

Velocity-Verlet (NVE) or BAOAB-style Langevin (NVT) stepping of one padded
batch, with the JAX package's two throughput features:

- **one force evaluation per step**: the end-of-step forces are the next
  step's start-of-step forces.  The port carries them across ``step`` calls
  and skin chunks too (the JAX package evaluates once more at the start of
  each; the values are the same up to the order of the neighbor sums), so a
  short rebuild cadence costs rebuilds, not evaluations;
- **Verlet-skin neighbor reuse** (``neighbor_skin`` > 0): the list is built
  with ``cutoff + skin`` once every ``rebuild_every`` steps and re-masked to
  the true cutoff every step (``NeighborList.refine``), exact while no atom
  moves more than skin/2 between rebuilds.  The largest displacement, the
  K-capacity overflow and the cell-list overflow fold into ``MDState.stale``,
  a tensor that stays on the device: no host fetch per chunk.

The port runs eagerly, one Python step at a time; there is no compiled scan.
Forces come from ``Potential.energy_and_forces`` (autograd).  The integrator
runs under ``torch.no_grad()``: each ``step`` call copies the state's
positions and velocities once and updates the copies in place, then
publishes a new ``MDState``, so tensors held from an earlier state never
change.  The carried forces belong to the state's ``pos`` tensor: a state
given new positions (a new tensor) gets its forces evaluated anew; do not
modify ``state.pos`` in place.  Random numbers (initial velocities,
Langevin noise) come from seeded ``torch.Generator``s on the run's device.

Units: positions in Angstrom, energies in eV, masses in amu, time in fs,
temperatures in Kelvin.
"""

import dataclasses
import math
from typing import Optional

import torch

from torchmdnet_tpu_torch.constants import ATOMIC_MASSES
from torchmdnet_tpu_torch.data.batch import AtomicBatch
from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
from torchmdnet_tpu_torch.utils import resolve_device

# 1 eV/A / amu in A/fs^2
_ACCEL = 0.00964853
# Boltzmann constant in eV/K
_KB = 8.617333262e-5

_PARALLEL_TODO = (
    "MD over a device mesh (mesh / edge_partition) is not ported yet "
    "(ROADMAP.md, 'Modules to port', slice F)"
)


@dataclasses.dataclass
class MDState:
    pos: torch.Tensor  # (N, 3) Angstrom
    vel: torch.Tensor  # (N, 3) A/fs
    energy: torch.Tensor  # (M, 1) eV, from the last force evaluation
    # scalar bool on the device: True if skin reuse may have missed neighbor
    # pairs (displacement > skin/2 between rebuilds, or a capacity overflow)
    stale: torch.Tensor


class Simulation:
    """Velocity-Verlet (NVE) or Langevin (NVT) dynamics for one padded batch.

    Args:
        model: a ``Potential``.  MD computes forces only, so its parameters
            are frozen (``requires_grad`` False), as ``External`` does.
        batch: the padded ``AtomicBatch``; padding atoms never move.
        neighbor_skin: Verlet-skin width (Angstrom); 0 rebuilds the neighbor
            list inside every force evaluation.
        rebuild_every: steps between neighbor rebuilds when skin > 0.
        neighbor_strategy: 'auto' | 'brute' | 'cell' for the skin builds.
        neighbor_kwargs: cell-list sizes; for large molecules the missing
            ``cell_capacity``/``max_cells`` are probed from ``batch`` here.
        device: where to run; ``cuda`` unless named (raises without a GPU).
        mesh, edge_partition: not ported (raise NotImplementedError).
    """

    def __init__(
        self,
        model,
        batch: AtomicBatch,
        timestep_fs: float = 1.0,
        friction_per_fs: float = 0.0,
        temperature_K: Optional[float] = None,
        box: Optional[torch.Tensor] = None,
        seed: int = 0,
        neighbor_skin: float = 0.0,
        rebuild_every: int = 20,
        neighbor_strategy: str = "auto",
        neighbor_kwargs: Optional[dict] = None,
        device=None,
        mesh=None,
        edge_partition: bool = False,
    ):
        if mesh is not None or edge_partition:
            raise NotImplementedError(_PARALLEL_TODO)
        self.device = dev = resolve_device(device)
        model.module.to(dev)
        model.device = dev
        for p in model.module.parameters():
            p.requires_grad_(False)
        self.model = model
        self.batch = batch = batch.to(dev)
        self.box = box = None if box is None else torch.as_tensor(box, device=dev)
        self.dt = float(timestep_fs)
        self.friction = float(friction_per_fs)
        self.temperature = temperature_K
        self.skin = float(neighbor_skin)
        self.rebuild_every = int(rebuild_every)
        self.neighbor_strategy = neighbor_strategy
        self._mask3 = batch.atom_mask[:, None]
        masses = torch.as_tensor(ATOMIC_MASSES, dtype=torch.float32, device=dev)[batch.z][:, None]
        self.masses = torch.where(self._mask3, masses, torch.ones_like(masses))
        self._lo = model.args.get("cutoff_lower", 0.0)
        self._hi = model.args.get("cutoff_upper", 5.0)
        self.neighbor_kwargs = probe_cell_kwargs(
            batch, neighbor_kwargs, cutoff_upper=self._hi + self.skin, box=box,
            strategy=neighbor_strategy,
        )
        # loud setup check (the reference's check_errors): a silently
        # truncated neighbor list would give wrong forces
        model.neighbors(batch, box=box, skin=self.skin, **self.neighbor_kwargs).raise_on_overflow(
            "the initial MD configuration"
        )
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        self._carried = None  # (pos, forces): the last evaluation and where it was made
        self.state = MDState(
            pos=batch.pos.clone(),
            vel=torch.zeros_like(batch.pos),
            energy=torch.zeros((batch.num_mol, 1), dtype=batch.pos.dtype, device=dev),
            stale=torch.zeros((), dtype=torch.bool, device=dev),
        )

    def set_velocities_from_temperature(self, temperature_K: float, seed: int = 1):
        """Maxwell-Boltzmann velocities, drawn from a generator seeded with ``seed``."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        pos = self.state.pos
        sigma = torch.sqrt(_KB * temperature_K / self.masses * _ACCEL)
        vel = sigma * torch.randn(pos.shape, generator=g, device=self.device, dtype=pos.dtype)
        vel = torch.where(self._mask3, vel, torch.zeros_like(vel))
        self.state = dataclasses.replace(self.state, vel=vel)

    def kinetic_energy(self) -> float:
        v2 = (self.state.vel ** 2).sum(-1, keepdim=True)
        ke = 0.5 * self.masses * v2 / _ACCEL
        return float(torch.where(self._mask3, ke, torch.zeros_like(ke)).sum())

    def potential_energy(self) -> float:
        with torch.no_grad():
            y = self.model.energy(self.batch.replace(pos=self.state.pos), box=self.box)
        return float(torch.where(self.batch.mol_mask[:, None], y, torch.zeros_like(y)).sum())

    def _forces(self, pos, nbl=None):
        y, f = self.model.energy_and_forces(self.batch.replace(pos=pos), box=self.box, nbl=nbl)
        return y, torch.where(self._mask3, f, torch.zeros_like(f))

    def _one_step(self, pos, vel, f, nbl):
        """One velocity-Verlet step on ``pos``/``vel`` in place; returns the
        end-of-step (energy, forces), which the next step starts from."""
        half = 0.5 * self.dt * _ACCEL
        vel += half * f / self.masses
        pos += self.dt * vel
        y, f = self._forces(pos, None if nbl is None else nbl.refine(pos, self._lo, self._hi, self.box))
        vel += half * f / self.masses
        if self.friction > 0.0 and self.temperature is not None:
            # BAOAB-style Langevin velocity update
            c1 = math.exp(-self.friction * self.dt)
            kT = _KB * self.temperature
            sigma = torch.sqrt((1 - c1 ** 2) * kT / self.masses * _ACCEL / self.dt * self.dt)
            noise = torch.randn(vel.shape, generator=self.generator, device=vel.device, dtype=vel.dtype)
            vel.mul_(c1).add_(sigma * noise)
        vel.masked_fill_(~self._mask3, 0.0)
        return y, f

    def _start_forces(self, pos, nbl=None):
        """Forces at the state's positions (``pos`` is a copy of them): the
        carried end-of-step forces of the last step, else one evaluation."""
        if self._carried is not None and self._carried[0] is self.state.pos:
            return self._carried[1]
        return self._forces(pos, nbl)[1]

    def _build_nbl(self, pos):
        return self.model.neighbors(
            self.batch.replace(pos=pos), box=self.box, skin=self.skin,
            strategy=self.neighbor_strategy, **self.neighbor_kwargs,
        )

    @torch.no_grad()
    def _run(self, n: int):
        """n steps with the list rebuilt inside every force evaluation."""
        pos, vel = self.state.pos.clone(), self.state.vel.clone()
        f = self._start_forces(pos)
        for _ in range(n):
            y, f = self._one_step(pos, vel, f, None)
        self.state = MDState(pos=pos, vel=vel, energy=y, stale=self.state.stale)
        self._carried = (pos, f)

    @torch.no_grad()
    def _run_chunk(self, chunk: int):
        """Rebuild the skin list at the current positions, then ``chunk``
        steps on it, tracking the largest displacement on the device."""
        pos0 = self.state.pos  # the list is built here
        nbl = self._build_nbl(pos0)
        pos, vel = pos0.clone(), self.state.vel.clone()
        f = self._start_forces(pos, nbl.refine(pos, self._lo, self._hi, self.box))
        d2max = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for _ in range(chunk):
            y, f = self._one_step(pos, vel, f, nbl)
            d2 = ((pos - pos0) ** 2).sum(dim=-1)
            d2max = torch.maximum(d2max, torch.where(self.batch.atom_mask, d2, torch.zeros_like(d2)).max())
        bad = (d2max > (0.5 * self.skin) ** 2) | nbl.overflow()
        if nbl.cell_overflow is not None:
            bad = bad | nbl.cell_overflow
        self.state = MDState(pos=pos, vel=vel, energy=y, stale=self.state.stale | bad)
        self._carried = (pos, f)

    def step(self, n: int = 1) -> MDState:
        """Advance ``n`` >= 1 steps; returns the new state."""
        if n < 1:
            raise ValueError(f"step takes n >= 1, got {n}")
        if self.skin > 0.0 and n >= self.rebuild_every:
            n_chunks, rem = divmod(n, self.rebuild_every)
            for _ in range(n_chunks):
                self._run_chunk(self.rebuild_every)
            if rem:
                self._run_chunk(rem)
        else:
            self._run(n)
        return self.state
