"""Training loop (counterpart of torchmdnet_tpu/train/trainer.py).

An explicit epoch loop around one optimizer step, with the JAX trainer's
behaviour:

- loss = y_weight * loss_y + neg_dy_weight * loss_neg_dy, train MSE, val L1
  and MSE, test L1; per-loss EMA smoothing with ema_alpha_y /
  ema_alpha_neg_dy (the EMA starts from 0 and carries across epochs);
- the force loss differentiates through the forces (grad-of-grad,
  ``force_grad_mode="gradgrad"``, the default): with ``fused_attention`` a
  step runs per layer the fused forward kernel once, the backward kernel
  twice and the second-order kernel once; or, with
  ``force_grad_mode="jvp"``, as the forward-mode tangent of the energy's
  parameter gradient (``_force_grads_jvp``, the JAX trainer's three
  passes): per layer the forward kernel three times and the backward
  kernel three times, the tangents composable and no second-order kernel;
- ``torch.optim.AdamW`` configured as ``optax.adamw`` (betas 0.9/0.999,
  eps 1e-8, decoupled weight decay passed explicitly), after global-norm
  clipping written out as ``optax.clip_by_global_norm`` does it;
- linear LR warmup, ReduceLROnPlateau on a monitored metric, early stop,
  top-k checkpoints every save_interval epochs, a test every test_interval
  epochs, resume (optimizer and trainer state unless reset_trainer);
- the first training batch's neighbor lists are checked on the host; every
  later batch's overflow flag accumulates on the device with the losses,
  read once per epoch.

The trainer trains the module's weights as they are (those ``create_model``
drew from its seed, or weights loaded into it); it does not re-initialise
them.  It runs on the potential's device.

Data parallelism (``mesh``, one process per rank, ``parallel/``): each rank
trains on its shard of every global batch (the loaders of ``DataModule``),
starting from rank 0's weights.  Every loss term is normalised by the GLOBAL
count of valid molecules or atoms, the gradients are summed over the ranks
in rank order, and the losses, metrics, LR schedule, early stopping and
checkpoint choice all read global values, so the ranks take the same steps
as one process on the global batch, up to the order of float sums.  Only
rank 0 writes logs and checkpoints.

Edge partitioning (``edge_partition``, ``parallel/edge_partition.py``):
every rank loads the same global batch, sorts it in space, builds the
global neighbor list and keeps its block of the atom rows; the model runs on
those rows with the exchanges of a ``RingExecutor`` sized from the first
batch (``edge_boundary_limit``), whose overflow flag accumulates with the
other capacity flags.  The energies are replicated on every rank and the
forces are the rank's rows: the energy loss's gradient reaches a rank's
parameters only through that rank's partials, the force loss covers the
rank's rows normalised by the global atom count, and the gradients are
summed over the ranks as under data parallelism.
"""

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.autograd.forward_ad as fwAD

from torchmdnet_tpu_torch.data.batch import spatial_sort
from torchmdnet_tpu_torch.models.potential import Potential, check_atom_filter_batch
from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
from torchmdnet_tpu_torch.parallel.distributed import (
    broadcast_,
    localize_shard,
    max_over_ranks,
    sum_gradients,
    sum_in_rank_order,
)
from torchmdnet_tpu_torch.train.checkpoints import (
    adamw_state_from_optax,
    latest_checkpoint,
    load_checkpoint,
    load_weights,
    save_checkpoint,
)
from torchmdnet_tpu_torch.train.loggers import make_loggers

def _masked_sum(err, mask):
    """The sum over valid rows of each row's mean error."""
    err = err.reshape(err.shape[0], -1).mean(dim=1)
    return torch.where(mask, err, torch.zeros_like(err)).sum()


def masked_mse(pred, target, mask, count=None):
    """Mean squared error over the valid rows; ``count`` (default the valid
    rows here) is the global count under data parallelism."""
    return _masked_sum((pred - target) ** 2, mask) / (mask.sum().clamp_min(1) if count is None else count)


def masked_l1(pred, target, mask, count=None):
    return _masked_sum((pred - target).abs(), mask) / (mask.sum().clamp_min(1) if count is None else count)


@dataclass
class TrainerState:
    epoch: int = 0
    global_step: int = 0
    lr: float = 1e-4
    best_metric: float = math.inf
    plateau_bad_epochs: int = 0
    early_stop_bad_epochs: int = 0
    ema: Dict[str, float] = field(default_factory=dict)


class Trainer:
    """``mesh`` (``parallel.mesh.make_mesh``): train data-parallel over its
    ranks, or with each batch's atom rows partitioned over them under
    ``edge_partition``; None trains in this process alone."""

    def __init__(self, model: Potential, hparams, mesh=None):
        self.model = model
        self.h = h = dict(hparams)
        if h.get("force_grad_mode", "gradgrad") not in ("gradgrad", "jvp"):
            raise ValueError(f"force_grad_mode must be 'gradgrad' or 'jvp', not {h['force_grad_mode']!r}")
        self._edge = bool(h.get("edge_partition"))
        if self._edge and mesh is None:
            raise ValueError("edge_partition needs a mesh (parallel.mesh.make_mesh(allow_single=True)); "
                             "pass --ndevices")
        self._ring = None  # the RingExecutor, sized from the first batch in fit
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.device = model.device
        self.log_dir = h.get("log_dir", "/tmp/logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.loggers = make_loggers(h, self.log_dir) if self.is_main else []
        self._ckpts = []  # (metric, path) of the top-k checkpoints
        # the JAX trainer sorts the batch in space for the fused kernels'
        # gather plan (ET's fused_attention, TensorNet's fused_message); the
        # port's kernels gather by index and keep the sort so that both see
        # the same atom order.  steps_per_dispatch and the gather-plan flags
        # are accepted: steps run one by one, the port builds no gather plan
        # (ROADMAP.md, section 3)
        self._fused = bool(h.get("fused_attention") or h.get("fused_message"))
        self._cell_kwargs = {}
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if mesh is not None:  # every rank starts from rank 0's weights
            broadcast_(mesh, list(model.module.state_dict().values()))
        self.optimizer = torch.optim.AdamW(
            self.params, lr=h.get("lr", 1e-4), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=h.get("weight_decay", 0.0),
        )
        self.clip = float(h.get("gradient_clipping", 0.0) or 0.0)
        self.state = TrainerState(lr=h.get("lr", 1e-4))
        self.first_step_loss = None  # total loss of fit's first step

    @property
    def dtype(self):
        return self.model.dtype

    def _print(self, text):
        if self.is_main:
            print(text)

    # --- one step ---------------------------------------------------------

    def _raise_on_overflow(self, count: float, context: str):
        if count > 0:
            raise ValueError(
                f"Neighbor capacity exceeded in {int(count)} batch(es) of {context}: an atom had "
                "more neighbors within a cutoff than a static capacity (max_num_neighbors or a "
                "prior's) and the list was truncated, which is wrong physics. Increase the capacity."
            )

    def _prepare_batch(self, batch):
        if self._edge:  # every rank holds the global batch: its grid, as one process sorts it
            return spatial_sort(batch, cell=self.h.get("cutoff_upper", 5.0))[0].to(self.device)
        if self.mesh is not None:
            batch = localize_shard(batch, self.mesh.rank)
        if self._fused:
            origin = None
            if self.mesh is not None:  # the global batch's grid: each molecule sorts as in one process
                low = batch.pos.amin(dim=0).to(self.device)
                origin = (-max_over_ranks(self.mesh, -low)).cpu()
            batch, _ = spatial_sort(batch, cell=self.h.get("cutoff_upper", 5.0), origin=origin)
        return batch.to(self.device)

    def _size_ring(self, batch):
        """The edge partition's executor, its boundary capacities sized once
        from ``batch`` (a global batch); later batches' boundaries are
        watched by ``RingContext.overflow``."""
        from torchmdnet_tpu_torch.parallel.edge_partition import sized_ring_executor

        self._ring = sized_ring_executor(
            self.model, self._prepare_batch(batch), self.mesh,
            boundary_limit=int(self.h.get("edge_boundary_limit") or 65536), cell_kwargs=self._cell_kwargs)

    def _build_nbl(self, batch):
        """The model's neighbor list and a 0/1 flag: did any capacity of this
        batch overflow (the model's list, its cells, a prior's list).  Under
        edge partitioning, this rank's ``RingContext`` of the global batch
        instead of the list (its flag folds the boundary capacities too)."""
        if self._ring is not None:
            ctx = self._ring.build(batch)
            return ctx, ctx.overflow.reshape(()).to(self.dtype)
        nbl = self.model.neighbors(batch, **self._cell_kwargs)
        flags = [nbl.overflow()]
        if nbl.cell_overflow is not None:
            flags.append(nbl.cell_overflow)
        for prior in self.model.module.priors:
            pn = prior.build_neighbor_list(batch.pos, batch.batch, batch.atom_mask)
            if pn is not None:
                flags.append(pn.overflow())
                if pn.cell_overflow is not None:
                    flags.append(pn.cell_overflow)
        over = torch.stack([f.reshape(()).to(torch.bool) for f in flags]).any()
        return nbl, over.to(self.dtype)

    def _uses_jvp(self, batch) -> bool:
        """Whether this step takes the force-loss gradient in forward mode
        (JAX's condition, trainer.py:292-297)."""
        h = self.h
        return (h.get("force_grad_mode", "gradgrad") == "jvp" and bool(h.get("derivative", False))
                and batch.neg_dy is not None and h.get("neg_dy_weight", 1.0) > 0)

    def _force_grads_jvp(self, batch, nbl, preds, counts):
        """The loss's parameter gradients into ``p.grad`` in forward mode
        (JAX's ``_force_grads_jvp``, trainer.py:325-400).  With g = the force
        loss's gradient at the current forces (``preds`` from a pass without
        a graph) and f = -dE/dpos, the force loss's gradient is g . df/dtheta
        = -d/dt grad_theta(sum E)(pos + t g): the tangent along g of the
        energy's parameter gradient (mixed partials commute).  Two passes
        more: the energy loss's gradient by one reverse pass, then the
        energy's parameter gradient with ``pos`` a dual tensor of tangent g.
        The fused kernels run the primals (#1, #2 with weights), their
        ``jvp`` rules the tangents; no second-order kernel runs.  Under edge
        partitioning the energy is the replicated one of this rank's rows,
        whose parameter gradient and tangent reach this rank's parameters
        through its partials only (the shares add up over the ranks, as
        ``sum_gradients`` adds them)."""
        h = self.h
        y_w, f_w = h.get("y_weight", 1.0), h.get("neg_dy_weight", 1.0)
        f, f_tgt, f_mask = preds["neg_dy"]
        f = f.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(
                f_w * h.get("ema_alpha_neg_dy", 1.0) * masked_mse(f, f_tgt, f_mask, count=counts[1]), f)
        if self._ring is not None:
            batch = self._ring.shard(batch)

        def energy(b):
            return self._ring.energy(b, nbl) if self._ring is not None else self.model.energy(b, nbl=nbl)

        if "y" in preds:
            _, y_tgt, y_mask = preds["y"]
            with torch.enable_grad():
                loss_y = y_w * h.get("ema_alpha_y", 1.0) * masked_mse(energy(batch), y_tgt, y_mask, count=counts[0])
            if loss_y.requires_grad:
                loss_y.backward()
        with fwAD.dual_level(), torch.enable_grad():
            pos = fwAD.make_dual(batch.pos.detach(), g.detach())
            e = energy(batch.replace(pos=pos))
            # create_graph: under grad mode autograd takes the composable
            # backward formulas, which carry tangents (silu_backward has no
            # forward-mode rule); the graph is dropped unused
            grads = torch.autograd.grad(e.sum(), self.params, allow_unused=True, create_graph=True)
            tangents = [None if gr is None else fwAD.unpack_dual(gr).tangent for gr in grads]
        for p, t in zip(self.params, tangents):
            if t is not None:
                p.grad = -t.detach() if p.grad is None else p.grad - t.detach()

    def _predictions(self, batch, nbl, train: bool):
        """Predictions against labels; ``train`` keeps the graph to the
        parameters (through the forces too: grad-of-grad)."""
        derivative = self.h.get("derivative", False)
        if self._ring is not None:  # nbl is the RingContext: this rank's rows
            batch = self._ring.shard(batch)
            if derivative:
                y, neg_dy = self._ring.energy_and_forces(batch, nbl, create_graph=train)
            else:
                with torch.set_grad_enabled(train):
                    y = self._ring.energy(batch, nbl)
        elif derivative:
            y, neg_dy = self.model.energy_and_forces(batch, nbl=nbl, create_graph=train)
        else:
            with torch.set_grad_enabled(train):
                y = self.model.energy(batch, nbl=nbl)
        if not derivative:
            neg_dy = None
        out = {}
        if batch.y is not None:
            out["y"] = (y, batch.y, batch.mol_mask)
        if derivative and batch.neg_dy is not None:
            out["neg_dy"] = (neg_dy, batch.neg_dy, batch.atom_mask)
        return out

    def _clip_grads(self):
        """optax.clip_by_global_norm: g / |g| * clip where the global norm
        |g| is at least clip, g unchanged below it; no host sync."""
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        clip = torch.as_tensor(self.clip, dtype=norm.dtype, device=norm.device)
        for g in grads:
            g.copy_(torch.where(norm < clip, g, g / norm * clip))

    def _train_step(self, batch, acc, ema_y, ema_f):
        """One optimizer step at the current global step's learning rate.
        ``acc`` (4,) accumulates (total, loss_y, loss_f, overflow) on the
        device; returns the smoothed (loss_y, loss_f), the next EMA values."""
        lr = self._current_lr(self.state)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        total, loss_y, loss_f, over = self.step_gradients(batch, ema_y, ema_f)
        self.on_before_optimizer_step()
        if self.clip > 0:
            self._clip_grads()
        self.optimizer.step()
        acc += torch.stack([total.detach(), loss_y.detach(), loss_f.detach(), over]).to(acc.dtype)
        self.state.global_step += 1
        return loss_y.detach(), loss_f.detach()

    def step_gradients(self, batch, ema_y, ema_f):
        """The gradients of one step's loss on ``batch`` (a prepared batch)
        into the parameters' ``.grad``, summed over the ranks, in
        ``force_grad_mode``; returns (total, loss_y, loss_f, overflow), the
        smoothed losses of the global batch.  Takes no optimizer step."""
        h = self.h
        alpha_y = h.get("ema_alpha_y", 1.0)
        alpha_f = h.get("ema_alpha_neg_dy", 1.0)
        y_w, f_w = h.get("y_weight", 1.0), h.get("neg_dy_weight", 1.0)
        nbl, over = self._build_nbl(batch)
        jvp = self._uses_jvp(batch)
        preds = self._predictions(batch, nbl, train=not jvp)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        counts = (None, None)
        if self.mesh is not None:  # normalised by the global batch's counts
            counts = self._global_counts(preds)
            has = counts > 0  # labels somewhere in the global batch (a rank's shard may be empty)
            counts = counts.clamp_min(1)
        mse_y = masked_mse(*preds["y"], count=counts[0]) if "y" in preds else zero
        mse_f = masked_mse(*preds["neg_dy"], count=counts[1]) if "neg_dy" in preds else zero
        # under data parallelism: this rank's share of the global loss, whose
        # gradient's seeds round as one process's (the EMA terms carry none)
        loss_y = alpha_y * mse_y + (1 - alpha_y) * ema_y if "y" in preds else zero
        loss_f = alpha_f * mse_f + (1 - alpha_f) * ema_f if "neg_dy" in preds else zero
        total = y_w * loss_y + f_w * loss_f
        self.optimizer.zero_grad(set_to_none=True)
        if jvp:
            self._force_grads_jvp(batch, nbl, preds, counts)
        elif total.requires_grad:
            total.backward()
        for p in self.params:  # optax updates every leaf, decay included
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            mse_y, mse_f, over = sum_gradients(
                self.mesh, self.params, self._rank_shares(torch.stack([mse_y.detach(), mse_f.detach(), over])))
            loss_y = torch.where(has[0], alpha_y * mse_y + (1 - alpha_y) * ema_y, zero)
            loss_f = torch.where(has[1], alpha_f * mse_f + (1 - alpha_f) * ema_f, zero)
            total = y_w * loss_y + f_w * loss_f
        return total, loss_y, loss_f, over

    def on_before_optimizer_step(self):
        """Called in every step once the gradients are complete (summed over
        the ranks), before clipping and the optimizer step, as Lightning's
        hook of that name; ``self.params``' gradients are readable here."""

    def _global_counts(self, preds):
        """(valid molecules, valid atoms) with labels in the global batch."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        local = torch.stack([preds[k][2].sum().to(self.dtype) if k in preds else zero for k in ("y", "neg_dy")])
        total = sum_in_rank_order(self.mesh, local)
        if self._edge:  # the molecules are whole on every rank, the atoms split
            return torch.stack([local[0], total[1]])
        return total

    def _rank_shares(self, terms):
        """(mse_y, mse_f, overflow) terms, or an evaluation row (y's three,
        neg_dy's three, overflow), as this rank's shares of their sums over
        the ranks: under edge partitioning the energy's terms and the flag are
        replicated, so rank 0 alone contributes them (adding zeros keeps its
        bits)."""
        if not self._edge or self.mesh.rank == 0:
            return terms
        keep = torch.zeros_like(terms, dtype=torch.bool)
        keep[-1 - terms.shape[0] // 2:-1] = True  # the force terms
        return torch.where(keep, terms, torch.zeros_like(terms))

    def _eval_step(self, batch):
        """(sums of the L1 and squared errors over the valid rows, and their
        counts, of y and neg_dy; the overflow flag) of this batch (this
        rank's shard of it)."""
        nbl, over = self._build_nbl(batch)
        preds = self._predictions(batch, nbl, train=False)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        terms = []
        for key in ("y", "neg_dy"):
            if key in preds:
                pred, target, mask = (t.detach() for t in preds[key])
                terms += [_masked_sum((pred - target).abs(), mask), _masked_sum((pred - target) ** 2, mask),
                          mask.sum().to(self.dtype)]
            else:
                terms += [zero, zero, zero]
        row = torch.stack(terms + [over])
        return row if self.mesh is None else self._rank_shares(row)

    def _current_lr(self, state: TrainerState):
        warmup = self.h.get("lr_warmup_steps", 0)
        if warmup and state.global_step < warmup:
            return state.lr * min(1.0, float(state.global_step + 1) / float(warmup))
        return state.lr

    # --- loops ------------------------------------------------------------

    def fit(self, datamodule, ckpt_path: Optional[str] = None):
        h = self.h
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        # setup checks on the first training batch: probed cell sizes for
        # large molecules, then every neighbor list checked on the host
        batch0 = next(iter(train_loader))
        if self.mesh is not None and not self._edge:
            batch0 = localize_shard(batch0, self.mesh.rank)
        batch0 = batch0.to(self.device)
        cutoff = h.get("cutoff_upper", 5.0)
        self._cell_kwargs = probe_cell_kwargs(batch0, cutoff_upper=cutoff)
        self.model.neighbors(batch0, **self._cell_kwargs).raise_on_overflow("the first training batch")
        for prior in self.model.module.priors:
            prior.probe_cell_sizes(batch0)
            prior.check_neighbor_capacity(batch0, "the first training batch")
        check_atom_filter_batch(self.model.module, batch0, "the first training batch")
        if self._edge:
            self._size_ring(batch0)

        if not ckpt_path and h.get("auto_resume"):
            ckpt_path = latest_checkpoint(self.log_dir)
            if ckpt_path:
                self._print(f"auto-resume: restoring from {ckpt_path}")
        if ckpt_path and not h.get("reset_trainer"):
            self._restore(ckpt_path)
        elif ckpt_path:
            load_weights(self.model.module, load_checkpoint(ckpt_path))

        state = self.state
        num_epochs = h.get("num_epochs", 300)
        patience = h.get("early_stopping_patience", 30)
        monitor = h.get("lr_metric", "val_total_mse_loss")
        for epoch in range(state.epoch, num_epochs):
            state.epoch = epoch
            metrics = {"epoch": float(epoch), "lr": self._current_lr(state)}
            metrics.update(self._run_train_epoch(train_loader))
            metrics.update(self._run_eval_epoch(val_loader, "val"))
            if h.get("test_interval", -1) > 0 and epoch > 0 and epoch % h["test_interval"] == 0:
                metrics.update(self._run_eval_epoch(datamodule.test_dataloader(), "test"))
            for logger in self.loggers:
                logger.log_metrics(metrics, step=state.global_step)
            monitored = metrics.get(monitor, metrics.get("val_total_mse_loss"))
            self._plateau_and_early_stop(monitored)
            if epoch % h.get("save_interval", 10) == 0 or monitored < state.best_metric:
                self._save_topk(metrics, monitored)
            if monitored < state.best_metric:
                state.best_metric = monitored
            if state.early_stop_bad_epochs >= patience:
                self._print(f"Early stopping at epoch {epoch}")
                break
            if state.lr < h.get("lr_min", 0.0):
                self._print(f"Learning rate fell below lr_min at epoch {epoch}")
                break
        return state

    def _run_train_epoch(self, loader):
        """One epoch; the losses and the overflow flag stay on the device and
        are read once at the end."""
        h = self.h
        state = self.state
        self.model.module.train()
        acc = torch.zeros(4, dtype=self.dtype, device=self.device)
        ema_y = torch.as_tensor(state.ema.get("train_y", 0.0), dtype=self.dtype, device=self.device)
        ema_f = torch.as_tensor(state.ema.get("train_neg_dy", 0.0), dtype=self.dtype, device=self.device)
        n = 0
        first = None
        for batch in loader:
            loss_y, loss_f = self._train_step(self._prepare_batch(batch), acc, ema_y, ema_f)
            if h.get("ema_alpha_y", 1.0) < 1:
                ema_y = loss_y
            if h.get("ema_alpha_neg_dy", 1.0) < 1:
                ema_f = loss_f
            if n == 0 and self.first_step_loss is None:
                first = acc[0].clone()
            n += 1
        totals, ys, fs, over = acc.tolist()  # the epoch's one fetch
        if first is not None:
            self.first_step_loss = float(first)
        self._raise_on_overflow(over, f"training epoch {state.epoch}")
        state.ema["train_y"] = float(ema_y)
        state.ema["train_neg_dy"] = float(ema_f)
        out = {"train_total_mse_loss": totals / max(n, 1)}
        if h.get("y_weight", 1.0) > 0:
            out["train_y_mse_loss"] = ys / max(n, 1)
        if h.get("derivative") and h.get("neg_dy_weight", 1.0) > 0:
            out["train_neg_dy_mse_loss"] = fs / max(n, 1)
        return out

    def _run_eval_epoch(self, loader, stage):
        """The stage's metrics: each batch's mean errors (over the global
        batch: every rank's sums and counts added first), averaged over the
        batches."""
        h = self.h
        self.model.module.eval()
        rows = [self._eval_step(self._prepare_batch(batch)) for batch in loader]
        sums = {}
        n = len(rows)
        if rows:
            table = torch.stack(rows)
            if self.mesh is not None:
                table = sum_in_rank_order(self.mesh, table)
            has = (bool(table[:, 2].sum() > 0), bool(table[:, 5].sum() > 0))  # labels in the stage
            for b in range(n):
                (y_l1, y_mse, y_n, f_l1, f_mse, f_n, over) = table[b]
                parts = {"overflow": over}
                if has[0]:
                    parts.update(y_l1=y_l1 / y_n.clamp_min(1), y_mse=y_mse / y_n.clamp_min(1))
                if has[1]:
                    parts.update(neg_dy_l1=f_l1 / f_n.clamp_min(1), neg_dy_mse=f_mse / f_n.clamp_min(1))
                for k, v in parts.items():
                    sums[k] = sums.get(k, 0.0) + v
        sums = {k: float(v) for k, v in sums.items()}
        self._raise_on_overflow(sums.pop("overflow", 0.0), f"the {stage} epoch")
        n = max(n, 1)
        metrics = {}
        y_w, f_w = h.get("y_weight", 1.0), h.get("neg_dy_weight", 1.0)
        if "y_l1" in sums:
            metrics[f"{stage}_y_l1_loss"] = sums["y_l1"] / n
            metrics[f"{stage}_y_mse_loss"] = sums["y_mse"] / n
        if "neg_dy_l1" in sums:
            metrics[f"{stage}_neg_dy_l1_loss"] = sums["neg_dy_l1"] / n
            metrics[f"{stage}_neg_dy_mse_loss"] = sums["neg_dy_mse"] / n
        metrics[f"{stage}_total_l1_loss"] = (y_w * sums.get("y_l1", 0.0) + f_w * sums.get("neg_dy_l1", 0.0)) / n
        metrics[f"{stage}_total_mse_loss"] = (y_w * sums.get("y_mse", 0.0) + f_w * sums.get("neg_dy_mse", 0.0)) / n
        return metrics

    def test(self, datamodule):
        """Test metrics of the module's current weights."""
        if self._edge and self._ring is None:  # no fit before
            self._size_ring(next(iter(datamodule.test_dataloader())))
        metrics = self._run_eval_epoch(datamodule.test_dataloader(), "test")
        for logger in self.loggers:
            logger.log_metrics(metrics, step=self.state.global_step)
        if self.is_main:
            print({k: round(v, 6) for k, v in metrics.items()})
        return metrics

    # --- plateau, early stop, checkpoints ---------------------------------

    def _plateau_and_early_stop(self, monitored: float):
        h = self.h
        state = self.state
        if monitored < state.best_metric:
            state.plateau_bad_epochs = 0
            state.early_stop_bad_epochs = 0
            return
        state.plateau_bad_epochs += 1
        state.early_stop_bad_epochs += 1
        if state.plateau_bad_epochs > h.get("lr_patience", 10):
            new_lr = max(state.lr * h.get("lr_factor", 0.8), h.get("lr_min", 1e-6))
            if new_lr < state.lr:
                self._print(f"Reducing learning rate to {new_lr:.3e}")
            state.lr = new_lr
            state.plateau_bad_epochs = 0

    def _save_topk(self, metrics, monitored):
        val = metrics.get("val_total_mse_loss", monitored)
        test_l1 = metrics.get("test_total_l1_loss", float("nan"))
        fname = f"epoch={self.state.epoch}-val_loss={val:.4f}-test_loss={test_l1:.4f}.ckpt"
        path = os.path.join(self.log_dir, fname)
        if self.is_main:  # every rank keeps the same list; rank 0 writes the files
            self.save_checkpoint(path)
        self._ckpts.append((monitored, path))
        self._ckpts.sort(key=lambda t: t[0])
        while len(self._ckpts) > 10:  # save_top_k = 10
            _, worst = self._ckpts.pop()
            if self.is_main and os.path.exists(worst):
                os.remove(worst)

    @property
    def best_model_path(self):
        return self._ckpts[0][1] if self._ckpts else None

    def save_checkpoint(self, path):
        """The weights, hyperparameters, optimizer and trainer state, and the
        standardization's mean and std (plain floats of the module, not in
        its state_dict; the reference keeps them as buffers)."""
        s = self.state
        module = self.model.module
        save_checkpoint(
            path, module.state_dict(), self.h,
            extra={"epoch": s.epoch + 1, "global_step": s.global_step, "lr": s.lr,
                   "best_metric": s.best_metric, "ema": dict(s.ema), "mean": module.mean, "std": module.std},
            optimizer=self.optimizer.state_dict(),
        )

    def _restore(self, path):
        ckpt = load_checkpoint(path)
        load_weights(self.model.module, ckpt)
        if ckpt.get("optimizer") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        elif ckpt.get("jax_opt_state") is not None:  # written by the JAX package's trainer
            adamw_state_from_optax(ckpt, self.optimizer, self.param_names)
        extra = ckpt["extra"]
        s = self.state
        s.epoch = extra.get("epoch", 0)
        s.global_step = extra.get("global_step", 0)
        s.lr = extra.get("lr", s.lr)
        s.best_metric = extra.get("best_metric", math.inf)
        s.ema = dict(extra.get("ema", {}))
