"""Training loop (counterpart of torchmdnet_tpu/train/trainer.py).

An explicit epoch loop around one optimizer step, with the JAX trainer's
behaviour:

- loss = y_weight * loss_y + neg_dy_weight * loss_neg_dy, train MSE, val L1
  and MSE, test L1; per-loss EMA smoothing with ema_alpha_y /
  ema_alpha_neg_dy (the EMA starts from 0 and carries across epochs);
- the force loss differentiates through the forces (grad-of-grad, the JAX
  trainer's default ``force_grad_mode="gradgrad"``): with
  ``fused_attention`` a step runs per layer the fused forward kernel once,
  the backward kernel twice and the second-order kernel once;
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
"""

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from torchmdnet_tpu_torch.data.batch import spatial_sort
from torchmdnet_tpu_torch.models.potential import Potential, check_atom_filter_batch
from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
from torchmdnet_tpu_torch.train.checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint
from torchmdnet_tpu_torch.train.loggers import make_loggers

_LATER_SLICES = {
    "force_grad_mode": "force_grad_mode='jvp' (forward-over-reverse) is not ported; the port "
                       "trains force losses by grad-of-grad (ROADMAP.md, queue 1 item 8, training leftovers)",
    "edge_partition": "edge partitioning needs the parallel layer (ROADMAP.md, queue 1 item 9, slice G)",
    "ndevices": "training on more than one device needs the parallel layer (ROADMAP.md, queue 1 item 9, "
                "slice G)",
    "num_nodes": "multi-host training needs the parallel layer (ROADMAP.md, queue 1 item 9, slice G)",
}


def masked_mse(pred, target, mask):
    se = (pred - target) ** 2
    se = se.reshape(se.shape[0], -1).mean(dim=1)
    return torch.where(mask, se, torch.zeros_like(se)).sum() / mask.sum().clamp_min(1)


def masked_l1(pred, target, mask):
    ae = (pred - target).abs()
    ae = ae.reshape(ae.shape[0], -1).mean(dim=1)
    return torch.where(mask, ae, torch.zeros_like(ae)).sum() / mask.sum().clamp_min(1)


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
    def __init__(self, model: Potential, hparams):
        self.model = model
        self.h = h = dict(hparams)
        if h.get("force_grad_mode", "gradgrad") == "jvp":
            raise NotImplementedError(_LATER_SLICES["force_grad_mode"])
        if h.get("edge_partition"):
            raise NotImplementedError(_LATER_SLICES["edge_partition"])
        if (h.get("ndevices") or 1) > 1:
            raise NotImplementedError(_LATER_SLICES["ndevices"])
        if (h.get("num_nodes") or 1) > 1:
            raise NotImplementedError(_LATER_SLICES["num_nodes"])
        self.device = model.device
        self.log_dir = h.get("log_dir", "/tmp/logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.loggers = make_loggers(h, self.log_dir)
        self._ckpts = []  # (metric, path) of the top-k checkpoints
        # the JAX trainer sorts the batch in space for the fused kernels'
        # gather plan (ET's fused_attention, TensorNet's fused_message); the
        # port's kernels gather by index and keep the sort so that both see
        # the same atom order.  steps_per_dispatch and the gather-plan flags
        # are accepted: steps run one by one, the port builds no gather plan
        # (ROADMAP.md, section 3)
        self._fused = bool(h.get("fused_attention") or h.get("fused_message"))
        self._cell_kwargs = {}
        self.params = [p for p in model.module.parameters() if p.requires_grad]
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

    # --- one step ---------------------------------------------------------

    def _raise_on_overflow(self, count: float, context: str):
        if count > 0:
            raise ValueError(
                f"Neighbor capacity exceeded in {int(count)} batch(es) of {context}: an atom had "
                "more neighbors within a cutoff than a static capacity (max_num_neighbors or a "
                "prior's) and the list was truncated, which is wrong physics. Increase the capacity."
            )

    def _prepare_batch(self, batch):
        if self._fused:
            batch, _ = spatial_sort(batch, cell=self.h.get("cutoff_upper", 5.0))
        return batch.to(self.device)

    def _build_nbl(self, batch):
        """The model's neighbor list and a 0/1 flag: did any capacity of this
        batch overflow (the model's list, its cells, a prior's list)."""
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

    def _predictions(self, batch, nbl, train: bool):
        """Predictions against labels; ``train`` keeps the graph to the
        parameters (through the forces too: grad-of-grad)."""
        derivative = self.h.get("derivative", False)
        if derivative:
            y, neg_dy = self.model.energy_and_forces(batch, nbl=nbl, create_graph=train)
        else:
            with torch.set_grad_enabled(train):
                y = self.model.energy(batch, nbl=nbl)
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
        h = self.h
        alpha_y = h.get("ema_alpha_y", 1.0)
        alpha_f = h.get("ema_alpha_neg_dy", 1.0)
        y_w, f_w = h.get("y_weight", 1.0), h.get("neg_dy_weight", 1.0)
        lr = self._current_lr(self.state)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        nbl, over = self._build_nbl(batch)
        preds = self._predictions(batch, nbl, train=True)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        loss_y = loss_f = zero
        if "y" in preds:
            loss_y = alpha_y * masked_mse(*preds["y"]) + (1 - alpha_y) * ema_y
        if "neg_dy" in preds:
            loss_f = alpha_f * masked_mse(*preds["neg_dy"]) + (1 - alpha_f) * ema_f
        total = y_w * loss_y + f_w * loss_f
        self.optimizer.zero_grad(set_to_none=True)
        if total.requires_grad:
            total.backward()
        for p in self.params:  # optax updates every leaf, decay included
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip > 0:
            self._clip_grads()
        self.optimizer.step()
        acc += torch.stack([total.detach(), loss_y.detach(), loss_f.detach(), over]).to(acc.dtype)
        self.state.global_step += 1
        return loss_y.detach(), loss_f.detach()

    def _eval_step(self, batch):
        nbl, over = self._build_nbl(batch)
        preds = self._predictions(batch, nbl, train=False)
        out = {"overflow": over}
        if "y" in preds:
            pred, target, mask = (t.detach() for t in preds["y"])
            out["y_l1"] = masked_l1(pred, target, mask)
            out["y_mse"] = masked_mse(pred, target, mask)
        if "neg_dy" in preds:
            pred, target, mask = (t.detach() for t in preds["neg_dy"])
            out["neg_dy_l1"] = masked_l1(pred, target, mask)
            out["neg_dy_mse"] = masked_mse(pred, target, mask)
        return out

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
        batch0 = next(iter(train_loader)).to(self.device)
        cutoff = h.get("cutoff_upper", 5.0)
        self._cell_kwargs = probe_cell_kwargs(batch0, cutoff_upper=cutoff)
        self.model.neighbors(batch0, **self._cell_kwargs).raise_on_overflow("the first training batch")
        for prior in self.model.module.priors:
            prior.check_neighbor_capacity(batch0, "the first training batch")
        check_atom_filter_batch(self.model.module, batch0, "the first training batch")

        if not ckpt_path and h.get("auto_resume"):
            ckpt_path = latest_checkpoint(self.log_dir)
            if ckpt_path:
                print(f"auto-resume: restoring from {ckpt_path}")
        if ckpt_path and not h.get("reset_trainer"):
            self._restore(ckpt_path)
        elif ckpt_path:
            self.model.module.load_state_dict(load_checkpoint(ckpt_path)["state_dict"])

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
                print(f"Early stopping at epoch {epoch}")
                break
            if state.lr < h.get("lr_min", 0.0):
                print(f"Learning rate fell below lr_min at epoch {epoch}")
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
        h = self.h
        self.model.module.eval()
        sums = {}
        n = 0
        for batch in loader:
            for k, v in self._eval_step(self._prepare_batch(batch)).items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
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
        metrics = self._run_eval_epoch(datamodule.test_dataloader(), "test")
        for logger in self.loggers:
            logger.log_metrics(metrics, step=self.state.global_step)
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
                print(f"Reducing learning rate to {new_lr:.3e}")
            state.lr = new_lr
            state.plateau_bad_epochs = 0

    def _save_topk(self, metrics, monitored):
        val = metrics.get("val_total_mse_loss", monitored)
        test_l1 = metrics.get("test_total_l1_loss", float("nan"))
        fname = f"epoch={self.state.epoch}-val_loss={val:.4f}-test_loss={test_l1:.4f}.ckpt"
        path = os.path.join(self.log_dir, fname)
        self.save_checkpoint(path)
        self._ckpts.append((monitored, path))
        self._ckpts.sort(key=lambda t: t[0])
        while len(self._ckpts) > 10:  # save_top_k = 10
            _, worst = self._ckpts.pop()
            if os.path.exists(worst):
                os.remove(worst)

    @property
    def best_model_path(self):
        return self._ckpts[0][1] if self._ckpts else None

    def save_checkpoint(self, path):
        s = self.state
        save_checkpoint(
            path, self.model.module.state_dict(), self.h,
            extra={"epoch": s.epoch + 1, "global_step": s.global_step, "lr": s.lr,
                   "best_metric": s.best_metric, "ema": dict(s.ema)},
            optimizer=self.optimizer.state_dict(),
        )

    def _restore(self, path):
        ckpt = load_checkpoint(path)
        self.model.module.load_state_dict(ckpt["state_dict"])
        if ckpt.get("optimizer") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        extra = ckpt["extra"]
        s = self.state
        s.epoch = extra.get("epoch", 0)
        s.global_step = extra.get("global_step", 0)
        s.lr = extra.get("lr", s.lr)
        s.best_metric = extra.get("best_metric", math.inf)
        s.ema = dict(extra.get("ema", {}))
