"""Ziegler-Biersack-Littmark screened nuclear repulsion prior (counterpart of
torchmdnet_tpu/priors/zbl.py).

A four-exponential screening function under a cosine cutoff, summed over the
prior's own neighbor list and added per molecule after the reduction.  The
factor 0.5 accounts for each pair appearing twice in the symmetric list.
"""

from typing import Dict, Sequence

import torch

from torchmdnet_tpu_torch.constants import BOHR_RADIUS_M, COULOMB_CONSTANT_JM
from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, ell_gather, neighbor_list
from torchmdnet_tpu_torch.priors.base import BasePrior, molecular_pair_energy_sum


class ZBL(BasePrior):
    """``atomic_number`` maps atom types to atomic numbers; positions times
    ``distance_scale`` are meters, energies times ``energy_scale`` Joules."""

    def __init__(self, cutoff_distance: float = 4.0, max_num_neighbors: int = 32,
                 atomic_number: Sequence[int] = (), distance_scale: float = 1e-10,
                 energy_scale: float = 1.0):
        super().__init__()
        self.cutoff_distance = float(cutoff_distance)
        self.max_num_neighbors = int(max_num_neighbors)
        self.atomic_number = tuple(int(v) for v in atomic_number)
        self.cell_kwargs = {}  # the cell list's sizes: JAX's defaults until probed
        self.distance_scale = float(distance_scale)
        self.energy_scale = float(energy_scale)
        # the type -> Z map in the model's float dtype, as the JAX package
        # takes it; not in the state_dict (the JAX prior has no parameters)
        self.register_buffer("zmap", torch.tensor(self.atomic_number, dtype=torch.float64), persistent=False)

    def get_init_args(self) -> Dict:
        return {
            "cutoff_distance": self.cutoff_distance,
            "max_num_neighbors": self.max_num_neighbors,
            "atomic_number": list(self.atomic_number),
            "distance_scale": self.distance_scale,
            "energy_scale": self.energy_scale,
        }

    def build_neighbor_list(self, pos, batch_ids, atom_mask):
        return neighbor_list(pos, batch_ids, atom_mask, k=self.max_num_neighbors, cutoff_lower=0.0,
                             cutoff_upper=self.cutoff_distance, loop=False, **self.cell_kwargs)

    def post_reduce(self, y, z, pos, batch_ids, atom_mask, num_mol, extra=None):
        nbl = self.build_neighbor_list(pos, batch_ids, atom_mask)
        _, dist = edge_geometry_components(pos, nbl)
        zt = self.zmap.to(pos.dtype)[z]  # (N,)
        zi = zt[:, None]
        zj = ell_gather(zt, nbl.idx, nbl.lazy_perm)  # (N, K); global ids under edge partitioning
        a = 0.8854 * BOHR_RADIUS_M / (zi ** 0.23 + zj ** 0.23)
        dist_safe = torch.where(nbl.mask, dist, torch.ones_like(dist))
        d = dist_safe * self.distance_scale / a
        f = (
            0.1818 * torch.exp(-3.2 * d)
            + 0.5099 * torch.exp(-0.9423 * d)
            + 0.2802 * torch.exp(-0.4029 * d)
            + 0.02817 * torch.exp(-0.2016 * d)
        )
        f = f * cosine_cutoff(dist_safe, 0.0, self.cutoff_distance)
        e_pair = f * zi * zj / dist_safe
        e_mol = molecular_pair_energy_sum(e_pair, batch_ids, atom_mask, nbl.mask, num_mol)
        e_mol = 0.5 * (COULOMB_CONSTANT_JM / self.energy_scale / self.distance_scale) * e_mol
        return y + e_mol.reshape(y.shape)
