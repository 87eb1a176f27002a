"""Serving-time evaluator with neighbor reuse (counterpart of torchmdnet_tpu/optimize.py).

``optimize(model, example)`` returns an ``OptimizedPotential`` bound to the
example batch's shapes: calling it with positions returns (energies,
forces).  What it adds over ``Potential.energy_and_forces``:

- the setup-time cell probe: for large molecules the cell list's
  ``cell_capacity`` and ``max_cells`` are sized from the example's
  positions (``ops/cell_list.probe_cell_kwargs``);
- optional Verlet-skin neighbor reuse across calls (``skin`` > 0): the list
  is rebuilt every ``rebuild_every`` calls with ``cutoff + skin`` and
  re-masked to the true cutoff on every call (``NeighborList.refine``),
  exact while no atom moves more than skin/2 between rebuilds.  The
  displacement bound and the capacity overflows are tracked on the device;
  the ``stale`` property fetches them lazily (one host fetch when read).

The port runs eagerly, so the JAX package's cached executables, donated
buffers and split threshold (one program for small systems, neighbor and
network programs apart above 6144 atoms) have no counterpart: every call
builds or refines its list through ``Potential.neighbors`` and then runs
the network.
"""

from typing import Optional

import torch

from torchmdnet_tpu_torch.data.batch import AtomicBatch
from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
from torchmdnet_tpu_torch.utils import resolve_device


class OptimizedPotential:
    """Energy/force evaluator for a fixed batch signature.

    Args:
        model: a ``Potential``; serving computes forces only, so its
            parameters are frozen (``requires_grad`` False).
        example: the padded batch whose shapes, atom types and masks every
            call shares; calls pass new positions.
        skin: Verlet-skin width (Angstrom); 0 builds a list every call.
        rebuild_every: calls between neighbor rebuilds when skin > 0.  Pick
            skin >= 2 * rebuild_every * (largest move per call) and read
            ``stale`` now and then to check the choice.
        neighbor_kwargs: ``strategy`` and the cell-list sizes.
        device: where to run; ``cuda`` unless named (raises without a GPU).
    """

    def __init__(self, model, example: AtomicBatch, box=None, skin: float = 0.0,
                 rebuild_every: int = 20, neighbor_kwargs: Optional[dict] = None, device=None):
        self.device = dev = resolve_device(device)
        model.module.to(dev)
        model.device = dev
        for p in model.module.parameters():
            p.requires_grad_(False)
        self.model = model
        self._template = example = example.to(dev)
        self.box = None if box is None else torch.as_tensor(box, device=dev)
        self.skin = float(skin)
        self.rebuild_every = int(rebuild_every)
        self._lo = model.args.get("cutoff_lower", 0.0)
        self._hi = model.args.get("cutoff_upper", 5.0)
        kw = dict(neighbor_kwargs or {})
        self.neighbor_kwargs = probe_cell_kwargs(
            example, kw, cutoff_upper=self._hi + self.skin, box=self.box,
            strategy=kw.get("strategy", "auto"),
        )
        self._nbl = None
        self._ref_pos = None
        self._calls_since_rebuild = 0
        self._stale = torch.zeros((), dtype=torch.bool, device=dev)

    @property
    def stale(self) -> bool:
        """True if skin reuse may have missed neighbor pairs since the last
        reset (displacement > skin/2 between rebuilds, or a capacity
        overflow).  Fetches one scalar from the device."""
        return bool(self._stale)

    def reset_stale(self):
        self._stale = torch.zeros((), dtype=torch.bool, device=self.device)

    def _neighbors(self, batch):
        return self.model.neighbors(batch, box=self.box, skin=self.skin, **self.neighbor_kwargs)

    def __call__(self, pos):
        """(energies (M, 1), forces (N, 3)) at ``pos`` (N, 3)."""
        t = self._template
        pos = torch.as_tensor(pos, dtype=t.pos.dtype, device=self.device).reshape(t.pos.shape)
        batch = t.replace(pos=pos)
        if self.skin <= 0.0:
            return self.model.energy_and_forces(batch, box=self.box, nbl=self._neighbors(batch))
        if self._nbl is None or self._calls_since_rebuild >= self.rebuild_every:
            self._nbl = self._neighbors(batch)
            self._ref_pos = pos.clone()
            self._calls_since_rebuild = 0
        nbl = self._nbl
        with torch.no_grad():
            d2 = ((pos - self._ref_pos) ** 2).sum(dim=-1)
            drift2 = torch.where(t.atom_mask, d2, torch.zeros_like(d2)).max()
            bad = (drift2 > (0.5 * self.skin) ** 2) | nbl.overflow()
            if nbl.cell_overflow is not None:
                bad = bad | nbl.cell_overflow
            self._stale = self._stale | bad
        self._calls_since_rebuild += 1
        return self.model.energy_and_forces(
            batch, box=self.box, nbl=nbl.refine(pos, self._lo, self._hi, self.box)
        )


def optimize(model, example: AtomicBatch, box=None, skin: float = 0.0, rebuild_every: int = 20,
             neighbor_kwargs: Optional[dict] = None, device=None) -> OptimizedPotential:
    """An ``OptimizedPotential`` bound to ``example``'s shapes.  Every model
    and configuration the port builds is supported."""
    return OptimizedPotential(
        model, example, box=box, skin=skin, rebuild_every=rebuild_every,
        neighbor_kwargs=neighbor_kwargs, device=device,
    )
