"""ctypes bridge to the native collation engine (counterpart of
torchmdnet_tpu/data/native_collate.py).

The engine is the port's copy of the JAX package's ``collate.cpp``
(``torchmdnet_tpu_torch/csrc/collate.cpp``), built at first use by the host's
C++ compiler into ``_build/`` (``ops/kernels/build.py``, named by a hash of
the source and flags) and loaded with ctypes.  ``PaddedLoader`` takes it
under the JAX package's gate (float32 batches, no per-atom field but
``partial_charges``, one process); its batches are bitwise those of
``pad_molecules``, in the same dtypes.

Unlike the JAX package, which warns and falls back to numpy when the library
cannot be built, a build or load failure raises, naming ``use_native=False``
(the loader's switch to the numpy path).
"""

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

SOURCE = "collate.cpp"
_LIB = None


def load_library() -> ctypes.CDLL:
    """The engine, built first if needed; raises if it cannot be built or
    loaded."""
    global _LIB
    if _LIB is None:
        from torchmdnet_tpu_torch.ops.kernels import build

        try:
            lib = build.load(SOURCE)
        except (OSError, RuntimeError) as e:
            raise RuntimeError(f"the native collation engine could not be built or loaded ({e}); pass "
                               f"use_native=False to PaddedLoader to collate in numpy") from e
        lib.pad_collate.restype = ctypes.c_int
        lib.pad_collate.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 10
        _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _cat(mols, key, dtype, width=()):
    """The molecules' per-atom ``key`` rows concatenated; each molecule's must
    hold one row per atom (the engine reads exactly that many)."""
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [np.asarray(m[key], dtype=dtype).reshape(len(m["z"]), *width) for m in mols]), dtype=dtype))


def _per_mol(mols, key):
    return torch.from_numpy(np.asarray([np.asarray(m[key]).reshape(-1)[0] for m in mols], dtype=np.float32))


def fast_pad_collate(mols: Sequence[Dict[str, np.ndarray]], num_atoms: int, num_mol: int,
                     extra_atom_keys: Sequence[str] = ()) -> Dict[str, Optional[torch.Tensor]]:
    """``pad_molecules(mols, num_atoms, num_mol, extra_atom_keys)`` in float32
    through the engine: a dict of CPU tensors (z, pos, batch, atom_mask,
    mol_mask, y, neg_dy, q, s, pq; a label None where a molecule lacks it,
    ``pq`` the ``partial_charges`` field when asked for).  The per-atom
    field may only be ``partial_charges``."""
    if set(extra_atom_keys) - {"partial_charges"}:
        raise ValueError(f"the native collation carries no per-atom field but partial_charges: {extra_atom_keys}")
    if len(mols) > num_mol:
        raise ValueError(f"{len(mols)} molecules exceed the capacity {num_mol}")
    total = sum(len(m["z"]) for m in mols)
    if total > num_atoms:
        raise ValueError(f"batch needs {total} atom slots, capacity {num_atoms}")
    lib = load_library()

    def has(key):
        return bool(mols) and all(m.get(key) is not None for m in mols)

    offsets = torch.zeros(len(mols) + 1, dtype=torch.int64)
    torch.cumsum(torch.tensor([len(m["z"]) for m in mols], dtype=torch.int64), 0, out=offsets[1:])
    ins = dict(
        z=_cat(mols, "z", np.int64) if mols else torch.zeros(0, dtype=torch.int64),
        pos=_cat(mols, "pos", np.float32, (3,)) if mols else torch.zeros(0, 3, dtype=torch.float32),
        y=_per_mol(mols, "y") if has("y") else None,
        neg_dy=_cat(mols, "neg_dy", np.float32, (3,)) if has("neg_dy") else None,
        q=_per_mol(mols, "q") if has("q") else None,
        s=_per_mol(mols, "s") if has("s") else None,
        pq=(_cat(mols, "partial_charges", np.float32) if mols else torch.zeros(0, dtype=torch.float32))
        if "partial_charges" in extra_atom_keys else None,
    )
    f32 = torch.float32

    def empty(key, *shape):
        return None if ins[key] is None else torch.empty(shape, dtype=f32)

    out = dict(
        z=torch.empty(num_atoms, dtype=torch.int64), pos=torch.empty(num_atoms, 3, dtype=f32),
        batch=torch.empty(num_atoms, dtype=torch.int64), atom_mask=torch.empty(num_atoms, dtype=torch.bool),
        mol_mask=torch.empty(num_mol, dtype=torch.bool), y=empty("y", num_mol, 1),
        neg_dy=empty("neg_dy", num_atoms, 3), q=empty("q", num_mol), s=empty("s", num_mol),
        pq=empty("pq", num_atoms),
    )
    rc = lib.pad_collate(
        *(_ptr(ins[k]) for k in ("z", "pos", "y", "neg_dy", "q", "s", "pq")), _ptr(offsets),
        len(mols), num_atoms, num_mol,
        *(_ptr(out[k]) for k in ("z", "pos", "batch", "atom_mask", "mol_mask", "y", "neg_dy", "q", "s", "pq")),
    )
    if rc != 0:
        raise RuntimeError(f"pad_collate returned {rc}")
    return out
