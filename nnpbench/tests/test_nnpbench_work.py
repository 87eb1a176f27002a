"""The work counts of ``nnpbench/work/et.py`` against counts made by hand
at a toy shape, and the pairs they are counted on against a direct count."""

import numpy as np
import pytest
import torch

from nnpbench.tests import tiny  # noqa: F401
from nnpbench.reference import et as ref
from nnpbench.work import et

A = dict(embedding_dimension=8, num_rbf=4, num_layers=2)


def test_forward_flops_by_hand():
    # N = 3 atoms, 7 pairs with the 3 self pairs, H = 8, RBF = 4, 2 layers
    n, pairs, pairs_ne = 3, 7, 4
    embed = 2 * 4 * 4 * 8 + 2 * 3 * 16 * 8  # distance_proj on the 4 pairs, combine (2H -> H) on 3 atoms
    nodes = 2 * 3 * (8 * 8 + 8 * 8 + 8 * 24 + 3 * 8 * 24 + 8 * 24)  # q, k, v, vec_proj x3, o_proj
    filters = 2 * 7 * 4 * (8 + 24)  # dk (RBF -> H) and dv (RBF -> 3H) on every pair
    head = 2 * 3 * (3 * 8 * 8 + 3 * 8 * 4 + 16 * 8 + 8 * 8) + 2 * 3 * (3 * 4 * 4 + 3 * 4 * 1 + 8 * 4 + 4 * 2)
    assert et.forward_flops(A, n, pairs, pairs_ne) == embed + 2 * (nodes + filters) + head
    assert et.step_flops("md", A, n, pairs, pairs_ne) == 2 * et.forward_flops(A, n, pairs, pairs_ne)


def test_forward_pass_bytes_by_hand():
    n, pairs = 3, 7
    tc, simt, nbytes = et.passes(A, n, pairs)["fwd"]
    assert tc == 2 * 7 * 4 * 32 and simt == 36 * 7 * 8
    reads = 3 * 8 * 2 * 8 + 7 * (4 * 2 + 5 * 4 + 4) + 5 * 32 * 2  # q, k, v, vec (bf16); pair rows; filters
    writes = 3 * 8 * 4 * 4  # x_agg and vec_agg, f32
    assert nbytes == reads + writes


def test_floor_takes_the_larger_bound():
    peaks = {"bf16_tensor_flops": 1e12, "f32_flops": 1e11, "hbm_bytes_per_s": 1e9}
    assert et.floor_s((1e12, 0, 1e6), peaks) == (1.0, "operations")
    assert et.floor_s((0, 0, 2e9), peaks) == (2.0, "bytes")
    assert et.floor_s((1e12, 1e11, 0), peaks) == (2.0, "operations")


@pytest.mark.parametrize("seed", [1, 2])
def test_pairs_against_a_direct_count(seed):
    g = np.random.default_rng(seed)
    pos = torch.as_tensor(g.uniform(0, 12, size=(150, 3)), dtype=torch.float32)
    mol = torch.as_tensor(np.repeat([0, 1, 2], 50))
    i, j = ref.pairs_within(pos, mol, 0.0, 5.0, block=64)
    d = np.linalg.norm(pos.numpy()[:, None] - pos.numpy()[None], axis=-1)
    same = mol.numpy()[:, None] == mol.numpy()[None]
    expect = int(((d < 5.0) & same).sum())  # the diagonal gives the self pairs
    assert len(i) == expect
    assert int((i == j).sum()) == 150
