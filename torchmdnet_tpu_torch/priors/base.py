"""Prior model interface (counterpart of torchmdnet_tpu/priors/base.py).

Priors hook into the potential either per atom before the reduction
(``pre_reduce``) or per molecule after it (``post_reduce``).  They receive
the atom mask and the padded molecule capacity, so padded batches reduce
exactly.  ``get_init_args`` round-trips through checkpoints (``prior_args``
in the hyperparameters).
"""

from typing import Dict, Optional

from torch import nn


class BasePrior(nn.Module):
    def get_init_args(self) -> Dict:
        return {}

    def build_neighbor_list(self, pos, batch_ids, atom_mask):
        """The prior's own neighbor list, or None if it has none (pair priors
        build one with their own cutoff and capacity)."""
        return None

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
