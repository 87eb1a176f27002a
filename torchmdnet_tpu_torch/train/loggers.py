"""Metrics loggers: CSV (always), optional W&B and TensorBoard (counterpart of
torchmdnet_tpu/train/loggers.py: the same columns, the same fallbacks).

Optional backends are gated on import availability (no hard deps).
"""

import csv
import os
from typing import Dict, List


class CSVLogger:
    """Single-header CSV: when new metric columns appear (e.g. test metrics
    on the first test epoch) the file is rewritten with the union header."""

    def __init__(self, log_dir):
        self.path = os.path.join(log_dir, "metrics.csv")
        self._fieldnames: List[str] = []
        self._rows: List[Dict[str, float]] = []

    def log_metrics(self, metrics: Dict[str, float], step: int = 0):
        row = dict(metrics)
        row["step"] = step
        self._rows.append(row)
        fields = sorted(set(self._fieldnames) | set(row.keys()))
        rewrite = fields != self._fieldnames or not os.path.exists(self.path)
        self._fieldnames = fields
        if rewrite:
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
                writer.writeheader()
                writer.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
                writer.writerow(row)


class WandbLogger:
    def __init__(self, project, name, save_dir, resume_id=None):
        import wandb

        self.run = wandb.init(
            project=project,
            name=name,
            dir=save_dir,
            resume="must" if resume_id else None,
            id=resume_id,
        )

    def log_metrics(self, metrics, step=0):
        self.run.log(metrics, step=step)


class TensorBoardLogger:
    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(os.path.join(log_dir, "tensorboard"))

    def log_metrics(self, metrics, step=0):
        for k, v in metrics.items():
            self.writer.add_scalar(k, v, step)


def make_loggers(hparams, log_dir):
    loggers = [CSVLogger(log_dir)]
    if hparams.get("wandb_use"):
        try:
            loggers.append(
                WandbLogger(
                    hparams.get("wandb_project", "training_"),
                    hparams.get("wandb_name", "training"),
                    log_dir,
                    hparams.get("wandb_resume_from_id"),
                )
            )
        except Exception as e:  # wandb not installed / offline
            print(f"W&B logger unavailable: {e}")
    if hparams.get("tensorboard_use"):
        try:
            loggers.append(TensorBoardLogger(log_dir))
        except Exception as e:
            print(f"TensorBoard logger unavailable: {e}")
    return loggers
