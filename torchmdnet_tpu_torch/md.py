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

Edge partitioning (``mesh`` + ``edge_partition=True``, one process per rank,
every rank constructing the Simulation with the same global batch): each
rank integrates its block of atom rows (``MDState.pos``/``vel`` hold them),
and every force evaluation runs partitioned (``parallel/edge_partition.py``:
no rank holds an (N, H) feature table).  The skin list is built globally at
the rebuild cadence from the gathered positions, and each rank keeps its
rows and exchange plan; ``stale`` folds the largest displacement over all
ranks with the capacity flags, the same on every rank.  Random numbers are
drawn for all N atoms and sliced, so a partitioned run follows the
single-process one.

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
        neighbor_strategy: 'auto' | 'brute' | 'brute-pallas' | 'cell' for
            the neighbor builds ('brute-pallas': the fused search kernel of
            ``ops/kernels/compaction.py``, no box).
        neighbor_kwargs: cell-list sizes; for large molecules the missing
            ``cell_capacity``/``max_cells`` are probed from ``batch`` here.
        device: where to run; ``cuda`` unless named (raises without a GPU).
            Under edge partitioning, the mesh's device.
        mesh + edge_partition: run every force evaluation edge-partitioned
            over the mesh's ranks (see the module docstring); requires
            neighbor_skin > 0.  ``boundary_limit`` caps the boundary
            capacities sized from ``batch``.  A mesh without
            ``edge_partition`` is not used, as in the JAX package.
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
        boundary_limit: int = 65536,
    ):
        if edge_partition:
            if mesh is None:
                raise ValueError("edge_partition=True requires a device mesh (parallel.mesh.make_mesh)")
            if float(neighbor_skin) <= 0.0:
                raise ValueError(
                    "edge_partition MD requires neighbor_skin > 0: the neighbor list is built globally at the "
                    "rebuild cadence and refined on each rank every step."
                )
            device = mesh.device
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
        # truncated neighbor list would give wrong forces.  It builds with the
        # strategy the steps build with (JAX's uses "auto", which for a
        # brute-force Simulation would build a cell list with unprobed sizes)
        model.neighbors(batch, box=box, skin=self.skin, strategy=neighbor_strategy,
                        **self.neighbor_kwargs).raise_on_overflow(
            "the initial MD configuration"
        )
        for prior in model.module.priors:
            prior.probe_cell_sizes(batch)
            prior.check_neighbor_capacity(batch, "the initial MD configuration")
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        self._carried = None  # (pos, forces): the last evaluation and where it was made
        self.ring = self.mesh = None
        if edge_partition:
            from torchmdnet_tpu_torch.parallel.edge_partition import shard_batch_by_atoms, sized_ring_executor

            self.mesh = mesh
            self.global_batch = batch
            skin_nbl = self._build_nbl(batch.pos)
            self.ring = sized_ring_executor(
                model, batch, mesh, nbl=skin_nbl, boundary_limit=boundary_limit, box=box,
                cell_kwargs=self.neighbor_kwargs,
            )
            del skin_nbl
            self.batch = batch = shard_batch_by_atoms(batch, mesh)
            self._mask3 = batch.atom_mask[:, None]
            nl = batch.num_atoms
            self.masses = self.masses[mesh.rank * nl:(mesh.rank + 1) * nl]
        self.state = MDState(
            pos=batch.pos.clone(),
            vel=torch.zeros_like(batch.pos),
            energy=torch.zeros((batch.num_mol, 1), dtype=batch.pos.dtype, device=dev),
            stale=torch.zeros((), dtype=torch.bool, device=dev),
        )

    def _randn(self, like, generator):
        """Normal draws shaped like ``like``; under edge partitioning drawn for
        all N atoms and sliced to this rank's rows, so every rank consumes
        the single-process stream."""
        if self.ring is None:
            return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)
        full = torch.randn((self.global_batch.num_atoms,) + tuple(like.shape[1:]), generator=generator,
                           device=like.device, dtype=like.dtype)
        nl = like.shape[0]
        return full[self.mesh.rank * nl:(self.mesh.rank + 1) * nl]

    def set_velocities_from_temperature(self, temperature_K: float, seed: int = 1):
        """Maxwell-Boltzmann velocities, drawn from a generator seeded with ``seed``."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        pos = self.state.pos
        sigma = torch.sqrt(_KB * temperature_K / self.masses * _ACCEL)
        vel = sigma * self._randn(pos, g)
        vel = torch.where(self._mask3, vel, torch.zeros_like(vel))
        self.state = dataclasses.replace(self.state, vel=vel)

    def kinetic_energy(self) -> float:
        v2 = (self.state.vel ** 2).sum(-1, keepdim=True)
        ke = 0.5 * self.masses * v2 / _ACCEL
        ke = torch.where(self._mask3, ke, torch.zeros_like(ke)).sum()
        if self.ring is not None:
            from torchmdnet_tpu_torch.parallel.distributed import sum_in_rank_order

            ke = sum_in_rank_order(self.mesh, ke)
        return float(ke)

    def potential_energy(self) -> float:
        with torch.no_grad():
            if self.ring is not None:
                ctx = self._build_ctx(self.state.pos)
                y = self.ring.energy(self.batch.replace(pos=self.state.pos), ctx, refine=(self._lo, self._hi))
            else:
                y = self.model.energy(self.batch.replace(pos=self.state.pos), box=self.box)
        return float(torch.where(self.batch.mol_mask[:, None], y, torch.zeros_like(y)).sum())

    def global_positions(self) -> torch.Tensor:
        """The positions of all N atoms (gathered from every rank under edge
        partitioning)."""
        if self.ring is None:
            return self.state.pos
        from torchmdnet_tpu_torch.parallel.edge_partition import gather_atom_rows

        return gather_atom_rows(self.mesh, self.state.pos)

    def _forces(self, pos, nbl=None):
        y, f = self.model.energy_and_forces(self.batch.replace(pos=pos), box=self.box, nbl=nbl)
        return y, torch.where(self._mask3, f, torch.zeros_like(f))

    def _forces_ring(self, pos, ctx):
        y, f = self.ring.energy_and_forces(self.batch.replace(pos=pos), ctx, refine=(self._lo, self._hi))
        return y, torch.where(self._mask3, f, torch.zeros_like(f))

    def _one_step(self, pos, vel, f, forces):
        """One velocity-Verlet step on ``pos``/``vel`` in place; ``forces(pos)``
        evaluates (energy, forces).  Returns the end-of-step (energy,
        forces), which the next step starts from."""
        half = 0.5 * self.dt * _ACCEL
        vel += half * f / self.masses
        pos += self.dt * vel
        y, f = forces(pos)
        vel += half * f / self.masses
        if self.friction > 0.0 and self.temperature is not None:
            # BAOAB-style Langevin velocity update
            c1 = math.exp(-self.friction * self.dt)
            kT = _KB * self.temperature
            sigma = torch.sqrt((1 - c1 ** 2) * kT / self.masses * _ACCEL / self.dt * self.dt)
            noise = self._randn(vel, self.generator)
            vel.mul_(c1).add_(sigma * noise)
        vel.masked_fill_(~self._mask3, 0.0)
        return y, f

    def _start_forces(self, pos, forces):
        """Forces at the state's positions (``pos`` is a copy of them): the
        carried end-of-step forces of the last step, else ``forces(pos)``."""
        if self._carried is not None and self._carried[0] is self.state.pos:
            return self._carried[1]
        return forces(pos)[1]

    def _build_nbl(self, pos):
        return self.model.neighbors(
            self.batch.replace(pos=pos), box=self.box, skin=self.skin,
            strategy=self.neighbor_strategy, **self.neighbor_kwargs,
        )

    @torch.no_grad()
    def _run(self, n: int):
        """n steps with the list rebuilt inside every force evaluation."""
        pos, vel = self.state.pos.clone(), self.state.vel.clone()
        f = self._start_forces(pos, self._forces)
        for _ in range(n):
            y, f = self._one_step(pos, vel, f, self._forces)
        self.state = MDState(pos=pos, vel=vel, energy=y, stale=self.state.stale)
        self._carried = (pos, f)

    def _build_ctx(self, pos):
        """The partitioned skin lists at this rank's positions ``pos``: the
        global list from every rank's positions, this rank's rows and plans."""
        from torchmdnet_tpu_torch.parallel.edge_partition import gather_atom_rows

        full = self.global_batch.replace(pos=gather_atom_rows(self.mesh, pos))
        return self.ring.build(full, skin=self.skin, strategy=self.neighbor_strategy, **self.neighbor_kwargs)

    def _skin_list(self, pos0):
        """The skin list built at ``pos0``: (forces(pos) on it, its capacity
        flags, the fold of a displacement over the ranks)."""
        if self.ring is not None:
            from torchmdnet_tpu_torch.parallel.distributed import max_over_ranks

            ctx = self._build_ctx(pos0)
            return (lambda p: self._forces_ring(p, ctx)), ctx.overflow, (lambda d2: max_over_ranks(self.mesh, d2))
        nbl = self._build_nbl(pos0)
        over = nbl.overflow() if nbl.cell_overflow is None else nbl.overflow() | nbl.cell_overflow
        return (lambda p: self._forces(p, nbl.refine(p, self._lo, self._hi, self.box))), over, (lambda d2: d2)

    @torch.no_grad()
    def _run_chunk(self, chunk: int):
        """Rebuild the skin list at the current positions, then ``chunk``
        steps on it, tracking the largest displacement on the device (over
        every rank under edge partitioning)."""
        pos0 = self.state.pos  # the list is built here
        forces, overflow, fold = self._skin_list(pos0)
        pos, vel = pos0.clone(), self.state.vel.clone()
        f = self._start_forces(pos, forces)
        d2max = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for _ in range(chunk):
            y, f = self._one_step(pos, vel, f, forces)
            d2 = ((pos - pos0) ** 2).sum(dim=-1)
            d2max = torch.maximum(d2max, torch.where(self.batch.atom_mask, d2, torch.zeros_like(d2)).max())
        bad = (fold(d2max) > (0.5 * self.skin) ** 2) | overflow
        self.state = MDState(pos=pos, vel=vel, energy=y, stale=self.state.stale | bad)
        self._carried = (pos, f)

    def step(self, n: int = 1) -> MDState:
        """Advance ``n`` >= 1 steps; returns the new state."""
        if n < 1:
            raise ValueError(f"step takes n >= 1, got {n}")
        # edge partitioning always runs on the skin list (built globally)
        if self.ring is not None or (self.skin > 0.0 and n >= self.rebuild_every):
            chunk = min(self.rebuild_every, n)
            n_chunks, rem = divmod(n, chunk)
            for _ in range(n_chunks):
                self._run_chunk(chunk)
            if rem:
                self._run_chunk(rem)
        else:
            self._run(n)
        return self.state
