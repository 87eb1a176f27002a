"""MD-engine calculator interface (counterpart of torchmdnet_tpu/calculators.py).

``External`` is the hook an MD engine calls once per step with positions (and
a box), returning energies and forces after an optional unit transform.
"""

from typing import Optional

import numpy as np
import torch

from torchmdnet_tpu_torch.data.batch import AtomicBatch
from torchmdnet_tpu_torch.models.potential import check_atom_filter_batch, load_model
from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
from torchmdnet_tpu_torch.utils import resolve_device

PAD_ATOMS = 32

transforms = {
    "eV/A -> kcal/mol/A": lambda energy, forces: (energy * 23.0609, forces * 23.0609),
    "Hartree/Bohr -> kcal/mol/A": lambda energy, forces: (
        energy * 627.509,
        forces * 627.509 / 0.529177,
    ),
    "Hartree/A -> kcal/mol/A": lambda energy, forces: (energy * 627.509, forces * 627.509),
}


class External:
    """Batched external potential for MD engines.

    Args:
        netfile: a checkpoint path (``load_model``), or a ``(Potential,
            state)`` tuple; ``state`` is a state_dict to load into the
            potential, or None to keep its weights.
        embeddings: (nbatch, natoms) atom types; replicas share types.
        device: where to run; ``cuda`` unless named (raises without a GPU).
        output_transform: a preset name from ``transforms``, a callable
            (energy, forces) -> (energy, forces), or the source of one, which
            is ``eval``ed as the reference does.
        use_box: set True when ``calculate`` will be called with a box.
        check_errors: check on the first ``calculate`` that the neighbor
            capacities hold for this system: the model's list and each
            prior's own (a host fetch each).

    The cell list's static sizes are probed from the first request, as
    ``md.Simulation`` probes them, for the model's list and for each pair
    prior's own: the defaults hold for the 5 A cutoff at DHFR size but not
    for TensorNet's 4.5 A or ZBL's 4 A, whose smaller cells number more.
    """

    def __init__(self, netfile, embeddings, device=None, output_transform=None,
                 use_box=False, check_errors=True):
        self.device = resolve_device(device)
        if isinstance(netfile, tuple):
            self.model, state = netfile
        else:
            self.model, state = load_model(netfile, device=self.device, derivative=True), None
        self.model.module.to(self.device)
        self.model.device = self.device
        if state is not None:
            self.model.module.load_state_dict(state)
        # serving computes forces only: no weight gradients
        for p in self.model.module.parameters():
            p.requires_grad_(False)

        embeddings = np.asarray(embeddings)
        self.n_batch, self.n_atoms = embeddings.shape
        self.n_real = self.n_batch * self.n_atoms
        # the atom rows are padded to a multiple of PAD_ATOMS with masked
        # atoms in the trash segment, the padded shape of the benchmark
        # systems (bench.py pads DHFR's 2489 atoms to 2496)
        n_total = -(-self.n_real // PAD_ATOMS) * PAD_ATOMS
        self.n_pad = n_total - self.n_real
        dev = self.device
        real = torch.arange(n_total, device=dev) < self.n_real
        batch_ids = torch.full((n_total,), self.n_batch, dtype=torch.int64, device=dev)
        batch_ids[: self.n_real] = torch.arange(self.n_batch, device=dev).repeat_interleave(self.n_atoms)
        z = torch.zeros(n_total, dtype=torch.int64, device=dev)
        z[: self.n_real] = torch.as_tensor(embeddings.reshape(-1), dtype=torch.int64, device=dev)
        self._template = AtomicBatch(
            z=z,
            pos=torch.zeros((n_total, 3), dtype=self.model.dtype, device=dev),
            batch=batch_ids,
            atom_mask=real,
            mol_mask=torch.ones(self.n_batch, dtype=torch.bool, device=dev),
            num_mol=self.n_batch,
        )
        # atom types are fixed at construction, so the filter can be checked here
        check_atom_filter_batch(self.model.module, self._template, "External")
        self.use_box = use_box
        if not output_transform:
            self.output_transformer = lambda energy, forces: (energy, forces)
        elif output_transform in transforms:
            self.output_transformer = transforms[output_transform]
        elif callable(output_transform):
            self.output_transformer = output_transform
        else:
            self.output_transformer = eval(output_transform)  # noqa: S307 (reference parity)
        self._check_errors = check_errors
        self._neighbor_kwargs = None

    def calculate(self, pos, box: Optional[torch.Tensor] = None):
        """One MD step: pos (nbatch*natoms, 3) or (nbatch, natoms, 3).

        Returns (energies (nbatch,), forces (nbatch, natoms, 3)).
        """
        if box is not None and not self.use_box:
            raise ValueError(
                "External was constructed with use_box=False but calculate() "
                "received a box; rebuild with use_box=True."
            )
        if box is None and self.use_box:
            raise ValueError("External was constructed with use_box=True but calculate() received no box.")
        dtype = self.model.dtype
        pos = torch.as_tensor(pos, dtype=dtype, device=self.device).reshape(-1, 3)
        if pos.shape[0] != self.n_real:
            raise ValueError(f"expected {self.n_real} positions, got {pos.shape[0]}")
        pos = torch.cat([pos, pos.new_zeros((self.n_pad, 3))])
        if box is not None:
            box = torch.as_tensor(box, dtype=dtype, device=self.device)
        batch = self._template.replace(pos=pos)
        if self._neighbor_kwargs is None:
            self._neighbor_kwargs = probe_cell_kwargs(
                batch, cutoff_upper=self.model.args.get("cutoff_upper", 5.0), box=box)
            # each pair prior's own list, at its cutoff
            for prior in self.model.module.priors:
                prior.probe_cell_sizes(batch)
        if self._check_errors:
            self._check_errors = False
            self.model.neighbors(batch, box=box, **self._neighbor_kwargs).raise_on_overflow(
                "External.calculate")
            for prior in self.model.module.priors:
                prior.check_neighbor_capacity(batch, "External.calculate")
        nbl = self.model.neighbors(batch, box=box, **self._neighbor_kwargs)
        energy, forces = self.model.energy_and_forces(batch, box=box, nbl=nbl)
        return self.output_transformer(
            energy.reshape(self.n_batch),
            forces[: self.n_real].reshape(self.n_batch, self.n_atoms, 3),
        )
