"""Synthetic benchmark systems (the port's copy of benchmarks/systems.py's generator).

Atoms at protein density (0.094 atoms/A^3) in a sphere, with protein-like
composition, so the neighbor counts per atom, which drive message-passing
cost, match a real protein of the same size (DHFR: 2489 atoms).
"""

import numpy as np

DENSITY = 0.094  # atoms / A^3
DHFR_ATOMS = 2489


def synthetic_system(n_atoms: int, seed: int = 0):
    """(z (n,) int32, pos (n, 3) float32), reproducible from ``seed``."""
    rng = np.random.default_rng(seed)
    volume = n_atoms / DENSITY
    radius = (3.0 * volume / (4.0 * np.pi)) ** (1.0 / 3.0)
    r = radius * rng.random(n_atoms) ** (1.0 / 3.0)
    v = rng.standard_normal((n_atoms, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (r[:, None] * v).astype(np.float32)
    z = rng.choice([1, 6, 7, 8, 16], size=n_atoms, p=[0.5, 0.32, 0.09, 0.08, 0.01])
    return z.astype(np.int32), pos
