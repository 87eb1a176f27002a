"""Prior model interface (counterpart of torchmdnet_tpu/priors/base.py).

Priors hook into the potential either per atom before the reduction
(``pre_reduce``) or per molecule after it (``post_reduce``).  They receive
the atom mask and the padded molecule capacity, so padded batches reduce
exactly.  ``get_init_args`` round-trips through checkpoints (``prior_args``
in the hyperparameters).

A pair prior builds its own neighbor list with the cell list's default sizes
(``cell_kwargs`` empty), as the JAX package's do; ``probe_cell_sizes`` sizes
them for a system instead.  JAX's defaults overflow the cells of ZBL's 4 A
list at DHFR size, where the model's own list is probed.
"""

from typing import Dict, Optional

import torch
from torch import nn

from torchmdnet_tpu_torch.ops.segment import segment_reduce


class BasePrior(nn.Module):
    def get_init_args(self) -> Dict:
        return {}

    def build_neighbor_list(self, pos, batch_ids, atom_mask):
        """The prior's own neighbor list, or None if it has none (pair priors
        build one with their own cutoff and capacity)."""
        return None

    def probe_cell_sizes(self, batch):
        """Size the cell list of this prior's own list for ``batch``, as
        ``External`` and ``md.Simulation`` size the model's
        (``probe_cell_kwargs``: large molecules only; batches of small ones
        keep the defaults).  A prior without a finite ``cutoff_distance``
        (Coulomb) keeps the defaults."""
        cutoff = getattr(self, "cutoff_distance", None)
        if cutoff is not None:
            from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

            self.cell_kwargs = probe_cell_kwargs(batch, cutoff_upper=cutoff)

    def check_neighbor_capacity(self, batch, context: str = ""):
        """Raise when this prior's neighbor list would silently drop pairs."""
        nbl = self.build_neighbor_list(batch.pos, batch.batch, batch.atom_mask)
        if nbl is not None:
            name = type(self).__name__
            nbl.raise_on_overflow(f"the {name} prior" + (f" on {context}" if context else ""))

    def pre_reduce(self, x, z, pos, batch_ids, atom_mask, extra: Optional[Dict] = None):
        """Update per-atom scalar predictions x (N, 1)."""
        return x

    def post_reduce(self, y, z, pos, batch_ids, atom_mask, num_mol: int, extra: Optional[Dict] = None):
        """Update per-molecule predictions y (M, ...)."""
        return y


def molecular_pair_energy_sum(e_pair, batch_ids, atom_mask, mask, num_mol: int):
    """Sum per-slot pair energies (N, K) into per-molecule energies (M, 1).

    Every pair appears twice in the symmetric ELL list, so callers apply the
    factor 0.5 themselves.  Masked slots and padding atoms add nothing (a
    select, so that a NaN computed there does not reach the sum or its
    gradient)."""
    e_pair = torch.where(mask, e_pair, torch.zeros_like(e_pair))
    per_atom = e_pair.sum(dim=1)  # (N,)
    per_atom = torch.where(atom_mask, per_atom, torch.zeros_like(per_atom))
    per_mol = segment_reduce(per_atom, batch_ids, num_mol + 1, "sum")
    return per_mol[:num_mol, None]
