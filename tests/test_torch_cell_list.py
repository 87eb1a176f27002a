"""The port's cell list held against the JAX package's and the port's brute search, on the CPU.

Every case builds the same inputs (numpy, seeded) with JAX's
``strategy="cell"``, the port's ``strategy="cell"`` and the port's brute
search, mirroring tests/test_cell_list.py.  Neighbor lists are integers:
idx, mask, n_neighbors and the ``cell_overflow`` flag are bitwise equal to
JAX's, and idx, mask and n_neighbors to brute's wherever the static sizes
hold.  On the CPU the compaction runs the selection kernel's plain version;
the kernel itself is held against it on the card by chip_smoke.py.  The
setup-time probes and ``spatial_sort`` return the same numbers as JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as j_pad_molecules
from torchmdnet_tpu.data.batch import spatial_sort as j_spatial_sort
from torchmdnet_tpu.ops import cell_list as j_cell
from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort
from torchmdnet_tpu_torch.ops import cell_list
from torchmdnet_tpu_torch.ops.neighbors import neighbor_list, transpose_perm

FIELDS = ("idx", "mask", "n_neighbors")


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


# these tiny programs run once: compile them with LLVM's cheap pipeline
# (numerics are unchanged; compile time halves)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
_COMPILED = {}


def _jax_cell(pos, batch, atom_mask, box, *, k, cutoff_lower=0.0, cutoff_upper=5.0, loop=False,
              cell_capacity=32, max_cells=None, max_dense_cells=1 << 18, hash_strategy=False):
    """JAX's ``neighbor_list_cell`` with its defaults (cell_list.py:638-679),
    its jitted body compiled with FAST_COMPILE: (idx, mask, n_neighbors,
    cell_overflow)."""
    n = pos.shape[0]
    args = (
        jnp.asarray(pos),
        jnp.zeros(n, jnp.int32) if batch is None else jnp.asarray(batch),
        jnp.ones(n, bool) if atom_mask is None else jnp.asarray(atom_mask),
        jnp.eye(3, dtype=pos.dtype) if box is None else jnp.asarray(box),
    )
    static = dict(k=k, cutoff_lower=float(cutoff_lower), cutoff_upper=float(cutoff_upper), loop=loop,
                  use_box=box is not None, cell_capacity=cell_capacity)
    if hash_strategy:
        fn = j_cell._neighbor_list_cell_hash
        static["num_buckets"] = 1 << max(4, (4 * n - 1).bit_length())
    else:
        fn = j_cell._neighbor_list_cell_tiles
        max_cells = max(256, -(-n // 8)) if max_cells is None else max_cells
        static.update(max_cells=-(-max_cells // 8) * 8, max_dense_cells=max_dense_cells)
    key = (fn.__name__, tuple(sorted(static.items())), tuple((a.shape, str(a.dtype)) for a in args))
    if key not in _COMPILED:
        _COMPILED[key] = fn.lower(*args, **static).compile(compiler_options=FAST_COMPILE)
    return _COMPILED[key](*args)


def _build(pos, batch=None, atom_mask=None, box=None, brute=True, **kw):
    """The port's cell list, held bitwise against JAX's and (when ``brute``)
    against the port's brute search."""
    ref = _jax_cell(pos, batch, atom_mask, box, **kw)
    if "hash_strategy" in kw or "cell_capacity" in kw or "max_cells" in kw:
        out = cell_list.neighbor_list_cell(_t(pos), _t(batch), _t(atom_mask), box=_t(box), **kw)
    else:
        out = neighbor_list(_t(pos), _t(batch), _t(atom_mask), box=_t(box), strategy="cell", **kw)
    for f, r in zip(FIELDS, ref):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(r), err_msg=f)
    assert bool(out.cell_overflow) == bool(ref[3])
    if not brute:
        return out
    kw = {a: b for a, b in kw.items() if a in ("k", "cutoff_lower", "cutoff_upper", "loop")}
    b = neighbor_list(_t(pos), _t(batch), _t(atom_mask), box=_t(box), strategy="brute", **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), getattr(b, f).numpy(), err_msg=f)
    assert not bool(out.cell_overflow)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cutoff", [1.5, 3.0])
@pytest.mark.parametrize("loop", [False, True])
def test_cell_matches_jax_and_brute(seed, cutoff, loop):
    rng = np.random.default_rng(seed)
    n = 70
    pos = (3.0 * rng.standard_normal((n, 3))).astype(np.float32)
    batch = np.sort(rng.integers(0, 3, n))
    nbl = _build(pos, batch, k=n, cutoff_upper=cutoff, loop=loop)
    assert int(nbl.n_neighbors.sum()) > 0  # the cutoff window holds pairs


def test_cell_pbc_rect_unwrapped_positions():
    rng = np.random.default_rng(5)
    pos = (7.0 * rng.random((60, 3)) - 20.0).astype(np.float32)
    _build(pos, box=np.diag([7.0, 7.0, 7.0]).astype(np.float32), k=60, cutoff_upper=2.0)


def test_cell_triclinic_box_raises():
    box = torch.tensor([[7.0, 0.0, 0.0], [1.0, 7.0, 0.0], [0.0, 0.0, 7.0]])
    with pytest.raises(ValueError, match="rectangular"):
        neighbor_list(torch.zeros(4, 3), k=2, cutoff_upper=2.0, box=box, strategy="cell")


def test_cell_padding_atoms():
    rng = np.random.default_rng(9)
    pos = np.zeros((40, 3), np.float32)
    pos[:30] = 5.0 * rng.standard_normal((30, 3))
    _build(pos, np.zeros(40, np.int64), np.arange(40) < 30, k=40, cutoff_upper=2.5, loop=True)


def test_cell_lower_cutoff():
    pos = (4.0 * np.random.default_rng(3).standard_normal((50, 3))).astype(np.float32)
    _build(pos, k=50, cutoff_lower=1.0, cutoff_upper=3.0)


@pytest.mark.parametrize("box", [None, 7.0])
def test_cell_hash_fallback(box):
    rng = np.random.default_rng(11)
    pos = (9.0 * rng.standard_normal((80, 3))).astype(np.float32)
    batch = np.sort(rng.integers(0, 2, 80))
    boxm = None if box is None else np.diag(np.full(3, box, np.float32))
    _build(pos, batch, box=boxm, k=80, cutoff_upper=2.5, hash_strategy=True)


def test_cell_capacity_and_max_cells_overflow_flags():
    # 40 atoms in one cell of capacity 4; 64 atoms spread over more cells than 8
    piled = np.random.default_rng(0).random((40, 3)).astype(np.float32)
    assert bool(_build(piled, k=40, cutoff_upper=5.0, cell_capacity=4, brute=False).cell_overflow)
    sparse = (100.0 * np.random.default_rng(2).standard_normal((64, 3))).astype(np.float32)
    assert bool(_build(sparse, k=8, cutoff_upper=1.0, max_cells=8, brute=False).cell_overflow)
    nbl = cell_list.neighbor_list_cell(torch.as_tensor(piled), k=40, cutoff_upper=5.0, cell_capacity=4)
    with pytest.raises(ValueError, match="Cell-list capacity exceeded"):
        nbl.raise_on_overflow()


def test_cell_f64_inputs_binned_in_f64():
    # cell edges on the positions' own grid: f64 coordinates a hair below a
    # multiple of the cutoff bin in the lower cell only in f64
    rng = np.random.default_rng(4)
    pos = 2.0 * rng.integers(0, 5, (48, 3)).astype(np.float64) - 1e-12 * rng.random((48, 3))
    pos += 0.3 * rng.standard_normal((48, 3))
    nbl = _build(pos, k=48, cutoff_upper=2.0, loop=True)
    assert nbl.idx.shape == (48, 49)


@pytest.mark.parametrize("box", [None, 19.0])
def test_probes_match_jax(box):
    rng = np.random.default_rng(6)
    pos = rng.uniform(0.0, 18.0, (300, 3)).astype(np.float32)
    mask = rng.random(300) > 0.1
    boxm = None if box is None else np.diag(np.full(3, box, np.float32))
    kw = dict(cutoff_upper=4.0, box=boxm)
    assert cell_list.suggest_cell_capacity(torch.as_tensor(pos), torch.as_tensor(mask), headroom=1.3, **kw) \
        == j_cell.suggest_cell_capacity(pos, mask, headroom=1.3, **kw)
    assert cell_list.suggest_max_cells(torch.as_tensor(pos), torch.as_tensor(mask), **kw) \
        == j_cell.suggest_max_cells(pos, mask, **kw)
    for args in ((2048, 1), (2047, 1), (4096, 8), (4096, 9), (30327, 1)):
        assert cell_list.wants_cell_probe(*args) == j_cell.wants_cell_probe(*args)


def test_auto_takes_the_cell_list_from_2048_atoms():
    rng = np.random.default_rng(7)
    for n, cell in ((2047, False), (2048, True)):
        pos = torch.as_tensor(rng.uniform(0.0, 28.0, (n, 3)).astype(np.float32))
        nbl = neighbor_list(pos, k=8, cutoff_upper=2.0)
        assert (nbl.cell_overflow is not None) == cell


def test_auto_keeps_brute_for_a_triclinic_box():
    # the cell strategy takes rectangular boxes only: from 2048 atoms 'auto'
    # builds the brute list for a reduced triclinic box instead of raising
    box = torch.tensor([[28.0, 0.0, 0.0], [5.0, 28.0, 0.0], [-4.0, 3.0, 28.0]])
    frac = np.random.default_rng(13).random((2048, 3)).astype(np.float32)
    pos = torch.as_tensor(frac) @ box
    kw = dict(k=16, cutoff_upper=2.5, loop=True, box=box)
    nbl = neighbor_list(pos, **kw)
    brute = neighbor_list(pos, strategy="brute", **kw)
    assert nbl.cell_overflow is None
    for f in FIELDS:
        assert torch.equal(getattr(nbl, f), getattr(brute, f)), f
    assert int(nbl.n_neighbors.sum()) > 0


def test_without_self_loops_derives_the_transpose_permutation():
    rng = np.random.default_rng(8)
    pos = torch.as_tensor((3.0 * rng.standard_normal((50, 3))).astype(np.float32))
    nbl = neighbor_list(pos, k=40, cutoff_upper=2.5, loop=True, strategy="cell")
    nbl.raise_on_overflow("test")
    child = nbl.without_self_loops()
    assert torch.equal(child.transpose_perm, transpose_perm(child.idx))
    assert bool(child.cell_overflow) is False


def test_spatial_sort_matches_jax():
    rng = np.random.default_rng(12)
    mols = [{"z": rng.integers(1, 9, n), "pos": rng.uniform(0.0, 16.0, (n, 3)).astype(np.float32)}
            for n in (30, 21)]
    jb, jorder = j_spatial_sort(j_pad_molecules(mols, num_atoms=56, num_mol=2), cell=4.0)
    pb, order = spatial_sort(pad_molecules(mols, num_atoms=56, num_mol=2), cell=4.0)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    for f in ("z", "pos", "batch", "atom_mask"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(pb.mol_mask.numpy(), np.asarray(jb.mol_mask))
