"""Synthetic protein-density systems, sorted in space.

Frozen copies, so that the yardstick does not move with the program:
``synthetic_system`` and ``DENSITY``/``STMV_ATOMS`` from
``torchmdnet_tpu_torch/data/systems.py`` (itself the port of
``benchmarks/systems.py``) and the cell-key order of
``data/batch.spatial_sort`` for one molecule.  ``lattice_system`` is the
benchmark's own: the same density and composition, with an excluded volume.
"""

import numpy as np

DENSITY = 0.094  # atoms / A^3
STMV_ATOMS = 30327


def synthetic_system(n_atoms: int, seed: int = 0):
    """(z (n,) int32, pos (n, 3) float32): atoms at protein density in a
    sphere with protein-like composition, reproducible from ``seed``."""
    rng = np.random.default_rng(seed)
    volume = n_atoms / DENSITY
    radius = (3.0 * volume / (4.0 * np.pi)) ** (1.0 / 3.0)
    r = radius * rng.random(n_atoms) ** (1.0 / 3.0)
    v = rng.standard_normal((n_atoms, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (r[:, None] * v).astype(np.float32)
    z = rng.choice([1, 6, 7, 8, 16], size=n_atoms, p=[0.5, 0.32, 0.09, 0.08, 0.01])
    return z.astype(np.int32), pos


def lattice_system(n_atoms: int, jitter: float, seed: int = 0, density: float = DENSITY):
    """(z (n,) int32, pos (n, 3) float32, side): ``n_atoms`` atoms at
    ``density`` in a periodic cube of ``side`` A, with ``synthetic_system``'s
    composition, from ``seed``.  The atoms take ``n_atoms`` sites, drawn at
    random, of the smallest simple cubic lattice that holds them, each moved
    off its site by a uniform draw of up to ``jitter`` lattice spacings a
    coordinate: no two atoms come closer than (1 - 2 ``jitter``) spacings,
    and no atom gathers many more neighbors than the mean."""
    rng = np.random.default_rng(seed)
    side = (n_atoms / density) ** (1.0 / 3.0)
    n = int(np.ceil(round(n_atoms ** (1.0 / 3.0), 9)))
    a = side / n
    sites = rng.permutation(n ** 3)[:n_atoms]
    ijk = np.stack(np.unravel_index(sites, (n, n, n)), axis=1)
    pos = ((ijk + 0.5 + jitter * (2.0 * rng.random((n_atoms, 3)) - 1.0)) * a).astype(np.float32)
    z = rng.choice([1, 6, 7, 8, 16], size=n_atoms, p=[0.5, 0.32, 0.09, 0.08, 0.01])
    return z.astype(np.int32), pos, side


def spatial_order(pos, cell: float = 5.0):
    """The storage order of one molecule's atoms by cutoff-wide cell keys
    (x, y, z), stable: the order ``spatial_sort`` gives them."""
    low = pos.min(axis=0)
    c = np.floor((pos - low) / float(cell)).astype(np.int64)
    span = int(max(c.max() + 1, 1))
    key = (c[:, 0] * span + c[:, 1]) * span + c[:, 2]
    return np.argsort(key, kind="stable")


def sorted_lattice(n_atoms: int, jitter: float, seed: int, cell: float = 5.0):
    """``lattice_system`` in spatial order: (z, pos, side)."""
    z, pos, side = lattice_system(n_atoms, jitter, seed)
    order = spatial_order(pos, cell)
    return z[order], pos[order], side
