"""Time ``External.calculate`` at DHFR size for the port in a given checkout.

    python3 torchmdnet_tpu_torch/tools/time_external.py [--tree DIR] [--label NAME]

``--tree`` names the root of a checkout whose ``torchmdnet_tpu_torch`` is
imported and built (default: the checkout holding this file), so that two
commits are timed on one card back to back: unpack the other commit with
``git archive`` into a git-ignored directory and run parent, change, change,
parent, one process each.  The request is chip_smoke.py's first one (its
``ET_ARGS``, the synthetic 2489-atom system, seed 0), taken from the
chip_smoke.py beside this package.  Prints the card's name and power limit,
then one JSON line: the host time of ``External.calculate`` (median of 20,
each call ended by a sync), the device time and kernel launches per call
(torch.profiler over 3 calls), and for each neighbor strategy the tree
offers, the list build alone and ``energy_and_forces`` on a list built in
the call (host clock, median of 20).  Needs a CUDA device.
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


def _device_ms_per_call(fn, calls=3):
    """torch.profiler's device time and kernel launches per call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    return sum(ev.device_time for ev in events) / 1e3 / calls, len(events) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Time External.calculate at DHFR size.")
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default=None, help="name printed with the result")
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
    potential = create_model(cs.ET_ARGS, seed=cs.SEED)
    ext = External((potential, None), z[None])
    result = dict(label=args.label or tree, tree=tree,
                  external_ms=cs._host_ms(lambda: ext.calculate(request)))
    result["device_ms_per_call"], result["launches_per_call"] = _device_ms_per_call(
        lambda: ext.calculate(request))

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
            list_ms=cs._host_ms(lambda: potential.neighbors(batch, strategy=strategy)),
            energy_and_forces_ms=cs._host_ms(
                lambda: potential.energy_and_forces(batch, nbl=potential.neighbors(batch, strategy=strategy))),
        )
    result["by_strategy"] = by_strategy
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
