"""erf-damped Coulomb prior (counterpart of torchmdnet_tpu/priors/coulomb.py).

Pairwise q_i q_j erf(alpha r) / r over every pair of atoms of a molecule,
with the per-atom partial charges that the dataset provides
(``batch.extra["partial_charges"]``, from a sample's ``pq``).
"""

from typing import Dict

import torch

from torchmdnet_tpu_torch.constants import COULOMB_CONSTANT_JM
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, ell_gather, neighbor_list
from torchmdnet_tpu_torch.priors.base import BasePrior, molecular_pair_energy_sum


class Coulomb(BasePrior):
    """``alpha`` is in 1/nm; positions times ``distance_scale`` are meters,
    energies times ``energy_scale`` Joules."""

    def __init__(self, alpha: float = 1.0, max_num_neighbors: int = 32, distance_scale: float = 1e-10,
                 energy_scale: float = 1.0):
        super().__init__()
        self.alpha = float(alpha)
        self.max_num_neighbors = int(max_num_neighbors)
        self.distance_scale = float(distance_scale)
        self.energy_scale = float(energy_scale)

    def get_init_args(self) -> Dict:
        return {
            "alpha": self.alpha,
            "max_num_neighbors": self.max_num_neighbors,
            "distance_scale": self.distance_scale,
            "energy_scale": self.energy_scale,
        }

    def build_neighbor_list(self, pos, batch_ids, atom_mask):
        # an infinite cutoff: every pair of a molecule (the scale of pos does
        # not matter).  From 2048 atoms "auto" takes the cell list, which puts
        # every atom in one cell and flags cell_overflow when a batch exceeds
        # its capacity, as the JAX package's does
        return neighbor_list(pos, batch_ids, atom_mask, k=self.max_num_neighbors, cutoff_lower=0.0,
                             cutoff_upper=float("inf"), loop=False)

    def post_reduce(self, y, z, pos, batch_ids, atom_mask, num_mol, extra=None):
        if extra is None or "partial_charges" not in extra:
            raise ValueError("The Coulomb prior needs per-atom partial charges: a dataset whose samples "
                             "carry 'pq' (batch.extra['partial_charges']).")
        # alpha * r is the same in any unit: evaluate in nm, as alpha is given
        pos_nm = 1e9 * self.distance_scale * pos
        nbl = self.build_neighbor_list(pos, batch_ids, atom_mask)
        _, dist = edge_geometry_components(pos_nm, nbl)
        dist_safe = torch.where(nbl.mask, dist, torch.ones_like(dist))
        pq = extra["partial_charges"]
        qi = pq[:, None]
        qj = ell_gather(pq, nbl.idx, nbl.lazy_perm)  # global ids under edge partitioning
        e_pair = torch.erf(self.alpha * dist_safe) * qi * qj / dist_safe
        e_mol = molecular_pair_energy_sum(e_pair, batch_ids, atom_mask, nbl.mask, num_mol)
        e_mol = 0.5 * (COULOMB_CONSTANT_JM / self.energy_scale / self.distance_scale) * e_mol
        return y + e_mol.reshape(y.shape)
