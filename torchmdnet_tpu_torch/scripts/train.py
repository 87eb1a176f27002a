"""Training CLI (counterpart of torchmdnet_tpu/scripts/train.py).

The same flags as the JAX package's entry point, plus ``--device`` (the
port's own), the YAML merge of ``--conf`` (CLI flags given after it
override it), the resolved configuration written to ``log_dir/input.yaml``
and the hyperparameters to ``log_dir/hparams.yaml`` (both as JSON, which
YAML readers accept), then data -> priors -> model -> Trainer.fit -> reload
the best checkpoint -> test.  Run it as

    python -m torchmdnet_tpu_torch.scripts.train --conf config.yaml

It trains on ``cuda`` unless ``--device`` names another device.  Flags of
later slices (``--force-grad-mode jvp``, ``--edge-partition``,
``--ndevices`` > 1, ``--num-nodes`` > 1) raise; ``--steps-per-dispatch``
runs its steps one by one, and the gather-plan flags are accepted and unused
(the port's kernels gather by index).
"""

import argparse
import json
import logging
import os
import sys

from torchmdnet_tpu_torch.ops.activations import act_fn_mapping
from torchmdnet_tpu_torch.ops.rbf import rbf_class_mapping
from torchmdnet_tpu_torch.utils import LoadFromCheckpoint, LoadFromFile, number, save_argparse

MODEL_CHOICES = ["graph-network", "transformer", "equivariant-transformer", "tensornet"]
PRIOR_CHOICES = ["Atomref", "D2", "ZBL", "Coulomb"]
# the JAX package's output heads; those not ported yet raise in create_model
HEAD_CHOICES = ["Scalar", "EquivariantScalar", "DipoleMoment", "EquivariantDipoleMoment",
                "ElectronicSpatialExtent", "EquivariantElectronicSpatialExtent",
                "EquivariantVectorOutput"]
PORT_ONLY_FLAGS = ("--device",)


def str2bool(value):
    """Boolean flags the JAX package added parse properly ('--fused-attention
    False' means False); the reference's own flags keep argparse's
    ``type=bool`` (any non-empty string is true), as the JAX package does."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("1", "true", "t", "yes", "y", "on"):
        return True
    if v in ("0", "false", "f", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def get_args(argv=None):
    # fmt: off
    parser = argparse.ArgumentParser(description="Training")
    parser.add_argument('--load-model', action=LoadFromCheckpoint, help='Restart training using a model checkpoint')  # keep first
    parser.add_argument('--conf', '-c', type=open, action=LoadFromFile, help='Configuration yaml file')  # keep second
    parser.add_argument('--num-epochs', default=300, type=int, help='number of epochs')
    parser.add_argument('--batch-size', default=32, type=int, help='batch size')
    parser.add_argument('--inference-batch-size', default=None, type=int, help='Batchsize for validation and tests.')
    parser.add_argument('--lr', default=1e-4, type=float, help='learning rate')
    parser.add_argument('--lr-patience', type=int, default=10, help='Patience for lr-schedule. Patience per eval-interval of validation')
    parser.add_argument('--lr-metric', type=str, default='val_total_mse_loss', choices=['train_total_mse_loss', 'val_total_mse_loss'], help='Metric to monitor when deciding whether to reduce learning rate')
    parser.add_argument('--lr-min', type=float, default=1e-6, help='Minimum learning rate before early stop')
    parser.add_argument('--lr-factor', type=float, default=0.8, help='Factor by which to multiply the learning rate when the metric stops improving')
    parser.add_argument('--lr-warmup-steps', type=int, default=0, help='How many steps to warm-up over. Defaults to 0 for no warm-up')
    parser.add_argument('--early-stopping-patience', type=int, default=30, help='Stop training after this many epochs without improvement')
    parser.add_argument('--reset-trainer', type=bool, default=False, help='Reset training metrics (e.g. early stopping, lr) when loading a model checkpoint')
    parser.add_argument('--auto-resume', type=str2bool, default=False, help='Resume from the newest checkpoint in log-dir when no --load-model is given (elastic restart after preemption/crash)')
    parser.add_argument('--weight-decay', type=float, default=0.0, help='Weight decay strength')
    parser.add_argument('--ema-alpha-y', type=float, default=1.0, help='The amount of influence of new losses on the exponential moving average of y')
    parser.add_argument('--ema-alpha-neg-dy', type=float, default=1.0, help='The amount of influence of new losses on the exponential moving average of dy')
    parser.add_argument('--ndevices', type=int, default=-1, help='Number of devices for data parallelism (-1 = all; more than one is not ported yet)')
    parser.add_argument('--num-nodes', type=int, default=1, help='Number of hosts (more than one is not ported yet)')
    parser.add_argument('--precision', type=int, default=32, choices=[16, 32, 64], help='Floating point precision (16 = bfloat16 compute)')
    parser.add_argument('--log-dir', '-l', default='/tmp/logs', help='log file')
    parser.add_argument('--splits', default=None, help='Npz with splits idx_train, idx_val, idx_test')
    parser.add_argument('--train-size', type=number, default=None, help='Percentage/number of samples in training set (None to use all remaining samples)')
    parser.add_argument('--val-size', type=number, default=0.05, help='Percentage/number of samples in validation set (None to use all remaining samples)')
    parser.add_argument('--test-size', type=number, default=0.1, help='Percentage/number of samples in test set (None to use all remaining samples)')
    parser.add_argument('--test-interval', type=int, default=-1, help='Test interval, one test per n epochs (default: 10)')
    parser.add_argument('--save-interval', type=int, default=10, help='Save interval, one save per n epochs (default: 10)')
    parser.add_argument('--seed', type=int, default=1, help='random seed (default: 1)')
    parser.add_argument('--num-workers', type=int, default=4, help='Number of workers for data prefetch')
    parser.add_argument('--redirect', type=bool, default=False, help='Redirect stdout and stderr to log_dir/log')
    parser.add_argument('--gradient-clipping', type=float, default=0.0, help='Gradient clipping norm')

    # dataset specific
    parser.add_argument('--dataset', default=None, type=str, help='Name of the dataset')
    parser.add_argument('--dataset-root', default='~/data', type=str, help='Data storage directory (not used if dataset is "CG")')
    parser.add_argument('--dataset-arg', default=None, help='Additional dataset arguments, e.g. target property for QM9 or molecule for MD17. JSON format.')
    parser.add_argument('--coord-files', default=None, type=str, help='Custom coordinate files glob')
    parser.add_argument('--embed-files', default=None, type=str, help='Custom embedding files glob')
    parser.add_argument('--energy-files', default=None, type=str, help='Custom energy files glob')
    parser.add_argument('--force-files', default=None, type=str, help='Custom force files glob')
    parser.add_argument('--y-weight', default=1.0, type=float, help='Weighting factor for y label in the loss function')
    parser.add_argument('--neg-dy-weight', default=1.0, type=float, help='Weighting factor for neg_dy label in the loss function')

    # model architecture
    parser.add_argument('--model', type=str, default='graph-network', choices=MODEL_CHOICES, help='Which model to train')
    parser.add_argument('--output-model', type=str, default='Scalar', choices=HEAD_CHOICES, help='The type of output model')
    parser.add_argument('--prior-model', type=str, default=None, choices=PRIOR_CHOICES, help='Which prior model to use')

    # architectural args
    parser.add_argument('--charge', type=bool, default=False, help='Model needs a total charge')
    parser.add_argument('--spin', type=bool, default=False, help='Model needs a spin state')
    parser.add_argument('--embedding-dimension', type=int, default=256, help='Embedding dimension')
    parser.add_argument('--num-layers', type=int, default=6, help='Number of interaction layers in the model')
    parser.add_argument('--num-rbf', type=int, default=64, help='Number of radial basis functions in model')
    parser.add_argument('--activation', type=str, default='silu', choices=list(act_fn_mapping.keys()), help='Activation function')
    parser.add_argument('--rbf-type', type=str, default='expnorm', choices=list(rbf_class_mapping.keys()), help='Type of distance expansion')
    parser.add_argument('--trainable-rbf', type=bool, default=False, help='If distance expansion functions should be trainable')
    parser.add_argument('--neighbor-embedding', type=bool, default=False, help='If a neighbor embedding should be applied before interactions')
    parser.add_argument('--aggr', type=str, default='add', help="Aggregation operation for CFConv filter output. Must be one of 'add', 'mean', or 'max'")

    # Transformer specific
    parser.add_argument('--distance-influence', type=str, default='both', choices=['keys', 'values', 'both', 'none'], help='Where distance information is included inside the attention')
    parser.add_argument('--attn-activation', default='silu', choices=list(act_fn_mapping.keys()), help='Attention activation function')
    parser.add_argument('--num-heads', type=int, default=8, help='Number of attention heads')

    # TensorNet specific
    parser.add_argument('--equivariance-invariance-group', type=str, default='O(3)', help='Equivariance and invariance group of TensorNet')

    # other args
    parser.add_argument('--derivative', default=False, type=bool, help='If true, take the derivative of the prediction w.r.t coordinates')
    parser.add_argument('--cutoff-lower', type=float, default=0.0, help='Lower cutoff in model')
    parser.add_argument('--cutoff-upper', type=float, default=5.0, help='Upper cutoff in model')
    parser.add_argument('--atom-filter', type=int, default=-1, help='Only sum over atoms with Z > atom_filter')
    parser.add_argument('--max-z', type=int, default=100, help='Maximum atomic number that fits in the embedding matrix')
    parser.add_argument('--max-num-neighbors', type=int, default=32, help='Maximum number of neighbors to consider in the network')
    parser.add_argument('--remat', type=str2bool, default=False, help='Rematerialize each interaction layer in backward passes (accepted; the port keeps the activations)')
    parser.add_argument('--bf16-messages', type=str2bool, default=False, help='Compute the message-passing gathers and products in bfloat16 with float32 accumulation')
    parser.add_argument('--fused-attention', type=str2bool, default=False, help='Route the equivariant-transformer edge phase through the fused CUDA kernels (requires bf16-messages; batches are spatially sorted). Force-loss training runs their second-order kernel')
    parser.add_argument('--force-grad-mode', type=str, default='gradgrad', choices=['gradgrad', 'jvp'], help='Force-loss gradient formulation: nested reverse ("gradgrad", default); "jvp" is not ported yet')
    parser.add_argument('--fused-message', type=str2bool, default=False, help='Route the tensornet message phase through its fused kernel (not ported yet)')
    parser.add_argument('--edge-partition', type=str2bool, default=False, help="Shard each batch's atom rows over the devices (not ported yet)")
    parser.add_argument('--edge-boundary-limit', type=int, default=65536, help='Upper limit on the boundary capacity of edge partitioning (not ported yet)')
    parser.add_argument('--plan-block-rows', type=int, default=0, help="Gather-plan rows per block (accepted and unused: the port's kernels gather by index)")
    parser.add_argument('--plan-width', type=int, default=0, help="Gather-plan width (accepted and unused: the port's kernels gather by index)")
    parser.add_argument('--steps-per-dispatch', type=int, default=8, help='Optimizer steps per dispatch in the JAX package; the port runs them one by one, with the same numbers')
    parser.add_argument('--loader-buckets', type=int, default=1, help='Size buckets for batch padding (1 = one worst-case capacity)')
    parser.add_argument('--standardize', type=bool, default=False, help='If true, multiply prediction by dataset std and add mean')
    parser.add_argument('--reduce-op', type=str, default='sum', choices=['sum', 'add', 'mean'], help='Reduce operation to apply to atomic predictions')
    parser.add_argument('--wandb-use', default=False, type=bool, help='Defines if wandb is used or not')
    parser.add_argument('--wandb-name', default='training', type=str, help='Give a name to your wandb run')
    parser.add_argument('--wandb-project', default='training_', type=str, help='Define what wandb Project to log to')
    parser.add_argument('--wandb-resume-from-id', default=None, type=str, help='Resume a wandb run from a given run id.')
    parser.add_argument('--tensorboard-use', default=False, type=bool, help='Defines if tensor board is used or not')
    # the port's own flags (PORT_ONLY_FLAGS)
    parser.add_argument('--device', default=None, type=str, help='Torch device to train on (default: cuda; raises without a GPU unless a device such as cpu is named)')
    # fmt: on

    args = parser.parse_args(argv)

    if args.redirect:
        os.makedirs(args.log_dir, exist_ok=True)
        sys.stdout = open(os.path.join(args.log_dir, "log"), "w")
        sys.stderr = sys.stdout
        logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))

    if args.inference_batch_size is None:
        args.inference_batch_size = args.batch_size

    os.makedirs(args.log_dir, exist_ok=True)
    save_argparse(args, os.path.join(args.log_dir, "input.yaml"), exclude=["conf"])
    return args


def main(argv=None):
    args = get_args(argv)
    hparams = vars(args)
    if isinstance(hparams.get("dataset_arg"), str):
        try:
            hparams["dataset_arg"] = json.loads(hparams["dataset_arg"])
        except json.JSONDecodeError:
            pass  # a single string argument, e.g. a QM9 label

    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.models.potential import create_model, create_prior_models, load_model
    from torchmdnet_tpu_torch.train.checkpoints import load_checkpoint
    from torchmdnet_tpu_torch.train.trainer import Trainer
    from torchmdnet_tpu_torch.utils import resolve_device

    device = resolve_device(hparams.get("device"))
    data = DataModule(hparams)
    data.setup()
    prior_models = create_prior_models(hparams, data.dataset)
    hparams["prior_args"] = [p.get_init_args() for p in prior_models]
    if hparams.get("load_model"):
        model = load_model(hparams["load_model"], args=hparams, device=device)
    else:
        model = create_model(hparams, prior_models, mean=data.mean, std=data.std, device=device,
                             seed=hparams.get("seed", 1))
    # the hyperparameters beside the checkpoints, for --load-model
    with open(os.path.join(args.log_dir, "hparams.yaml"), "w") as f:
        json.dump({k: v for k, v in hparams.items() if k != "conf"}, f, indent=1, default=str)

    trainer = Trainer(model, hparams)
    trainer.fit(data, ckpt_path=hparams.get("load_model"))
    # reload the best checkpoint and run the test set
    best = trainer.best_model_path
    if best is not None and os.path.exists(best):
        model.module.load_state_dict(load_checkpoint(best)["state_dict"])
    return trainer, trainer.test(data)


if __name__ == "__main__":
    main()
