"""Grimme DFT-D2 dispersion correction prior (counterpart of
torchmdnet_tpu/priors/d2.py).

Damped -s6 C6 / r^6 pair energies with the element table of Grimme 2006,
Table 1 (C6 in J/mol nm^6, van der Waals radii converted to nm; elements up
to Z = 54), computed in nm and J/mol.
"""

from typing import Dict, Sequence

import numpy as np
import torch

from torchmdnet_tpu_torch.constants import AVOGADRO
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, neighbor_list
from torchmdnet_tpu_torch.priors.base import BasePrior, molecular_pair_energy_sum

# fmt: off
# [C_6 (J/mol*nm^6), R_r (Angstrom)] per atomic number; Grimme 2006 Table 1.
_C6_RR = np.array([
    [np.nan, np.nan],
    [0.14, 1.001], [0.08, 1.012], [1.61, 0.825], [1.61, 1.408], [3.13, 1.485],
    [1.75, 1.452], [1.23, 1.397], [0.70, 1.342], [0.75, 1.287], [0.63, 1.243],
    [5.71, 1.144], [5.71, 1.364], [10.79, 1.639], [9.23, 1.716], [7.84, 1.705],
    [5.57, 1.683], [5.07, 1.639], [4.61, 1.595], [10.80, 1.485], [10.80, 1.474],
    [10.80, 1.562], [10.80, 1.562], [10.80, 1.562], [10.80, 1.562], [10.80, 1.562],
    [10.80, 1.562], [10.80, 1.562], [10.80, 1.562], [10.80, 1.562], [10.80, 1.562],
    [16.99, 1.650], [17.10, 1.727], [16.37, 1.760], [12.64, 1.771], [12.47, 1.749],
    [12.01, 1.727], [24.67, 1.628], [24.67, 1.606], [24.67, 1.639], [24.67, 1.639],
    [24.67, 1.639], [24.67, 1.639], [24.67, 1.639], [24.67, 1.639], [24.67, 1.639],
    [24.67, 1.639], [24.67, 1.639], [24.67, 1.639], [37.32, 1.672], [38.71, 1.804],
    [38.44, 1.881], [31.74, 1.892], [31.50, 1.892], [29.99, 1.881],
])
_C6_RR[:, 1] *= 0.1  # Angstrom -> nm
# fmt: on


class D2(BasePrior):
    """``atomic_number`` maps atom types to atomic numbers; positions times
    ``distance_scale`` are meters, energies times ``energy_scale`` Joules.
    ``get_init_args`` leaves out ``d`` and ``s_6``, as the JAX package's
    does: a checkpoint restores them at their defaults."""

    def __init__(self, cutoff_distance: float = 10.0, max_num_neighbors: int = 128,
                 atomic_number: Sequence[int] = (), distance_scale: float = 1e-10,
                 energy_scale: float = 1.0, d: float = 20.0, s_6: float = 1.0):
        super().__init__()
        self.cutoff_distance = float(cutoff_distance)
        self.max_num_neighbors = int(max_num_neighbors)
        self.atomic_number = tuple(int(v) for v in atomic_number)
        self.cell_kwargs = {}  # the cell list's sizes: JAX's defaults until probed
        self.distance_scale = float(distance_scale)
        self.energy_scale = float(energy_scale)
        self.d = float(d)
        self.s_6 = float(s_6)
        # not in the state_dict (the JAX prior has no parameters); the table
        # follows the model's float dtype, as the JAX package takes it
        self.register_buffer("zmap", torch.tensor(self.atomic_number, dtype=torch.int64), persistent=False)
        self.register_buffer("c6_rr", torch.as_tensor(_C6_RR), persistent=False)

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
        r_ij = dist * (self.distance_scale * 1e9)  # nm
        r_ij = torch.where(nbl.mask, r_ij, torch.ones_like(r_ij))
        energy_scale_jmol = self.energy_scale * AVOGADRO

        rows = self.c6_rr.to(pos.dtype)[self.zmap[z]]  # (N, 2); NaN for Z = 0
        idx = nbl.idx.long()
        c6 = torch.sqrt(rows[:, 0:1] * rows[idx, 0])
        rr = rows[:, 1:2] + rows[idx, 1]
        f_damp = 1.0 / (1.0 + torch.exp(-self.d * (r_ij / rr - 1.0)))
        e_pair = c6 / r_ij ** 6 * f_damp
        e_mol = molecular_pair_energy_sum(e_pair, batch_ids, atom_mask, nbl.mask, num_mol)
        e_disp = -self.s_6 * e_mol / 2.0
        return y + (e_disp / energy_scale_jmol).reshape(y.shape)
