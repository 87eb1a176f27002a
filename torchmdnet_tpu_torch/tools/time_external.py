"""Time ``External.calculate`` at DHFR size for the port in a given checkout.

    python3 torchmdnet_tpu_torch/tools/time_external.py [--tree DIR] [--label NAME]
        [--model et|transformer] [--train]

``--tree`` names the root of a checkout whose ``torchmdnet_tpu_torch`` is
imported and built (default: the checkout holding this file), so that two
commits are timed on one card back to back: unpack the other commit with
``git archive`` into a git-ignored directory and run parent, change, change,
parent, one process each.  The request is chip_smoke.py's first one (its
``ET_ARGS``, or ``T_ARGS`` with ``--model transformer``, the synthetic
2489-atom system, seed 0), taken from the chip_smoke.py beside this package.  Prints the card's name and power limit,
then one JSON line: the host time of ``External.calculate`` (median of 20,
each call ended by a sync), the device time and kernel launches per call
(torch.profiler over 3 calls), and for each neighbor strategy the tree
offers, the list build alone and ``energy_and_forces`` on a list built in
the call (host clock, median of 20).  ``--train`` adds a force-loss
``Trainer`` step of chip_smoke.py's training configuration (``TRAIN_ARGS``
or ``T_TRAIN_ARGS``, a batch of 128 SyntheticMorse molecules of 18 atoms):
host ms per step (median of 20 after 3, each ended by a sync) and device ms
per step (torch.profiler over 3 steps).  Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms_per_call(cs, fn, calls=3):
    """torch.profiler's device time and kernel launches per call of ``fn``."""
    _, busy, _, _, launches, _ = cs.profiling.kernel_profile(fn, calls, ())
    return busy, launches


def _train_step_ms(cs, model_args):
    """A force-loss Trainer step on one training batch: host ms (median of
    20 after 3) and device ms per step (profiler, 3 steps)."""
    import tempfile

    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(create_model(model_args, seed=cs.SEED),
                          dict(model_args, lr=1e-4, log_dir=workdir, y_weight=1.0, neg_dy_weight=1.0))
        batch = trainer._prepare_batch(cs._train_batch(cs._train_dataset(), "cpu"))
        acc = torch.zeros(4, dtype=trainer.dtype, device="cuda")
        ema = torch.zeros((), dtype=trainer.dtype, device="cuda")
        step = lambda: trainer._train_step(batch, acc, ema, ema)
        step_ms = cs.profiling.host_ms(step, reps=cs.TRAIN_TIMED_STEPS, warmup=cs.TRAIN_WARMUP_STEPS)
        device_ms, launches = _device_ms_per_call(cs, step)
    return dict(step_ms=step_ms, device_ms_per_step=device_ms, launches_per_step=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Time External.calculate at DHFR size.")
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--model", default="et", choices=("et", "transformer"), help="chip_smoke.py's configuration")
    ap.add_argument("--train", action="store_true", help="also time a force-loss training step")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or os.curdir) != here]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_external: no CUDA device", file=sys.stderr)
        return 1
    import torchmdnet_tpu_torch
    from torchmdnet_tpu_torch import External, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels import build

    if not os.path.abspath(torchmdnet_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {torchmdnet_tpu_torch.__file__}, not the package under {tree}")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    build.build()

    z, pos, _ = cs._synthetic_batch(DHFR_ATOMS, cs.SEED, "cpu")
    request = pos + np.random.default_rng(cs.SEED).normal(scale=0.02, size=pos.shape).astype(np.float32)
    potential = create_model(cs.T_ARGS if args.model == "transformer" else cs.ET_ARGS, seed=cs.SEED)
    ext = External((potential, None), z[None])
    result = dict(label=args.label or tree, tree=tree,
                  external_ms=cs.profiling.host_ms(lambda: ext.calculate(request)))
    result["device_ms_per_call"], result["launches_per_call"] = _device_ms_per_call(
        cs, lambda: ext.calculate(request))

    p = torch.as_tensor(request, device=ext.device)
    batch = ext._template.replace(pos=torch.cat([p, p.new_zeros((ext.n_pad, 3))]))
    by_strategy = {}
    for strategy in ("brute", "cell"):
        try:
            potential.neighbors(batch, strategy=strategy).raise_on_overflow("time_external")
        except NotImplementedError:
            by_strategy[strategy] = None  # the tree has no such strategy
            continue
        by_strategy[strategy] = dict(
            list_ms=cs.profiling.host_ms(lambda: potential.neighbors(batch, strategy=strategy)),
            energy_and_forces_ms=cs.profiling.host_ms(
                lambda: potential.energy_and_forces(batch, nbl=potential.neighbors(batch, strategy=strategy))),
        )
    result["by_strategy"] = by_strategy
    if args.train:
        result["train"] = _train_step_ms(cs, cs.T_TRAIN_ARGS if args.model == "transformer" else cs.TRAIN_ARGS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
