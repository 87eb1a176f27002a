"""The port's fused brute neighbor search (kernel #7's plain version) held
against the JAX package's, on the CPU.

- ``neighbor_list(strategy="brute-pallas")`` against JAX's, which runs
  ``compact_neighbors_pallas`` in interpret mode here: bitwise equal lists
  (idx, mask, true counts), with and without the self loop, on a batch of
  several molecules with masked atoms and a capacity that truncates some
  rows.  Both compute d^2 in the kernel's difference form.
- Against the port's own ``strategy="brute"`` (Gram form) on random
  positions, as tests/test_cell_list.py does for JAX's pair: the same lists
  unless a pair's d^2 lies within float rounding of a cutoff (none does
  here).
- A periodic box raises; CPU tensors take the plain version and count no
  launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.neighbors import neighbor_list as j_neighbor_list
from torchmdnet_tpu_torch.ops.kernels import compaction
from torchmdnet_tpu_torch.ops.neighbors import neighbor_list

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
N = 70


def _system(seed=7):
    """70 atoms in three molecules, about a tenth of them masked."""
    rng = np.random.default_rng(seed)
    pos = (2.0 * rng.standard_normal((N, 3))).astype(np.float32)
    batch = np.sort(rng.integers(0, 3, N)).astype(np.int32)
    mask = rng.random(N) > 0.1
    return pos, batch, mask


@pytest.mark.parametrize("loop", [False, True])
def test_brute_pallas_matches_jax_bitwise(loop):
    pos, batch, mask = _system()
    kw = dict(k=12, cutoff_lower=0.5, cutoff_upper=3.5, loop=loop, strategy="brute-pallas")

    def build(p, b, m):
        nbl = j_neighbor_list(p, b, m, **kw)
        return nbl.idx, nbl.mask, nbl.n_neighbors

    args = (jnp.asarray(pos), jnp.asarray(batch), jnp.asarray(mask))
    want = jax.jit(build).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    got = neighbor_list(torch.as_tensor(pos), torch.as_tensor(batch).long(), torch.as_tensor(mask), **kw)
    assert got.self_loops == loop and got.idx.dtype == torch.int32
    assert int(got.n_neighbors.max()) > 12  # some rows are truncated at the capacity
    for a, b in zip((got.idx, got.mask, got.n_neighbors), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("loop", [False, True])
def test_brute_pallas_matches_brute(loop):
    pos, batch, mask = _system(seed=3)
    t = (torch.as_tensor(pos), torch.as_tensor(batch).long(), torch.as_tensor(mask))
    kw = dict(k=24, cutoff_upper=3.5, loop=loop)
    b = neighbor_list(*t, strategy="brute", **kw)
    p = neighbor_list(*t, strategy="brute-pallas", **kw)
    assert torch.equal(b.idx, p.idx) and torch.equal(b.mask, p.mask)
    assert torch.equal(b.n_neighbors, p.n_neighbors)


def test_box_raises_and_cpu_tensors_take_the_plain_version():
    pos, batch, mask = _system()
    t = (torch.as_tensor(pos), torch.as_tensor(batch).long(), torch.as_tensor(mask))
    with pytest.raises(ValueError, match="box"):
        neighbor_list(*t, k=8, box=torch.eye(3) * 20.0, strategy="brute-pallas")
    compaction.reset_launch_counts()
    got = compaction.compact_neighbors(*t, k=8, cutoff_upper=3.0)
    want = compaction.compact_neighbors_reference(*t, k=8, cutoff_upper=3.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert compaction.compact_neighbors.launches == 0
    # masked atoms have no neighbors and point at themselves
    rows = torch.nonzero(~t[2]).reshape(-1)
    assert not got[1][rows].any() and int(got[2][rows].sum()) == 0
    assert torch.equal(got[0][rows], rows[:, None].expand(-1, 8).int())


def test_simulation_on_brute_pallas_matches_brute():
    """md.Simulation(neighbor_strategy="brute-pallas") steps exactly as on
    the brute strategy (the lists agree here), with skin rebuilds."""
    from torchmdnet_tpu_torch import Simulation, create_model
    from torchmdnet_tpu_torch.data.batch import pad_molecules

    args = dict(model="transformer", embedding_dimension=32, num_layers=1, num_rbf=8, rbf_type="expnorm",
                trainable_rbf=False, activation="silu", attn_activation="silu", neighbor_embedding=False,
                num_heads=4, distance_influence="both", cutoff_lower=0.0, cutoff_upper=3.0, max_z=100,
                max_num_neighbors=24, derivative=True, output_model="Scalar", prior_model=None,
                reduce_op="add", atom_filter=-1, precision=64)
    rng = np.random.default_rng(4)
    batch = pad_molecules([{"z": rng.integers(1, 9, 20), "pos": rng.uniform(0, 6.0, (20, 3))}], num_atoms=24,
                          float_dtype=np.float64)
    states = []
    for strategy in ("brute", "brute-pallas"):
        sim = Simulation(create_model(args, device="cpu", seed=1), batch, device="cpu", timestep_fs=0.5,
                         neighbor_skin=0.5, rebuild_every=2, neighbor_strategy=strategy)
        sim.set_velocities_from_temperature(100.0)
        states.append(sim.step(6))
    assert torch.equal(states[0].pos, states[1].pos) and not bool(states[1].stale)
    assert float((states[1].pos - batch.pos).abs().max()) > 1e-4  # the atoms moved
