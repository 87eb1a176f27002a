"""Time the fused ET backward kernel (#2) with and without weight
cotangents, and the second-order kernel (#3) where the tree has it, for the
port in a given checkout.

    python3 torchmdnet_tpu_torch/tools/time_bwd.py [--tree DIR] [--label NAME]

``--tree`` names the root of a checkout whose ``torchmdnet_tpu_torch`` is
imported and built (default: the checkout holding this file), so that two
commits (or two builds of one kernel source) are timed on one card back to
back, one process each, in the order parent, change, change, parent.  The
operands are chip_smoke.py's (the chip_smoke.py beside this package): the
DHFR shapes (N = 2496, K = 81, H = 128, RBF = 50) and the training shapes
(N = 2304, K = 33, H = 256, RBF = 64, a batch of 128 SyntheticMorse
molecules, drawn with this checkout's package, so that a tree without the
datasets is timed on the same batch).  Prints the card's name and power
limit, then one JSON line of CUDA-event medians of 20 launches with the L2
flushed.  Needs a CUDA device.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Time the fused ET backward and second-order kernels.")
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default=None, help="name printed with the result")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    cs = _chip_smoke()
    # the training molecules from this checkout's datasets, then the tree's package
    sys.path[:] = [ROOT] + rest
    train_ds = cs._train_dataset()
    train_mols = [train_ds[i] for i in range(cs.TRAIN_BATCH)]
    for name in [m for m in sys.modules if m.split(".")[0] == "torchmdnet_tpu_torch"]:
        del sys.modules[name]
    sys.path[:] = [tree] + rest

    import torch

    if not torch.cuda.is_available():
        print("time_bwd: no CUDA device", file=sys.stderr)
        return 1
    import torchmdnet_tpu_torch
    from torchmdnet_tpu_torch.ops.kernels import build
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    if not os.path.abspath(torchmdnet_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {torchmdnet_tpu_torch.__file__}, not the package under {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    build.build()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    a = cs.TRAIN_ARGS
    shapes = {
        "dhfr": dict(n_atoms=2489, k=80, h=128, heads=8, rbf=50, cutoff=5.0, batch=None),
        "train": dict(n_atoms=None, k=a["max_num_neighbors"], h=a["embedding_dimension"],
                      heads=a["num_heads"], rbf=a["num_rbf"], cutoff=a["cutoff_upper"],
                      batch=cs._train_batch(train_mols, "cuda")),
    }
    result = dict(label=args.label or tree, tree=tree)
    for name, s in shapes.items():
        nbl, ins, cts = cs._kernel_inputs(s["n_atoms"], s["k"], s["h"], s["rbf"], s["cutoff"], cs.SEED,
                                          batch=s["batch"])
        kw = dict(heads=s["heads"], act="silu", attn_act="silu")
        ops = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
        dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
        w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]

        def bwd(want):
            return lambda: em.run_bwd(nbl.idx, nbl.transpose_perm, *ops, dirs, *w, cts[0], cts[1],
                                      want_weight_grads=want, **kw)

        row = dict(bwd_ms=cs._event_ms(bwd(False), flush=flush),
                   bwd_weights_ms=cs._event_ms(bwd(True), flush=flush))
        if hasattr(em, "run_bwd2"):
            z = cs._z_like(ins, cs.SEED)
            row["bwd2_ms"] = cs._event_ms(
                lambda: em.run_bwd2(nbl.idx, nbl.transpose_perm, [ins[x] for x in cs.ORDER], cts, z, **kw),
                flush=flush)
        result[name] = row
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
