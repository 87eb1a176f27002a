#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchmdnet_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the port's main paths: ET energy and forces for a DHFR-sized system
through ``External.calculate`` (whose neighbor list now comes from the cell
list and the selection kernel), the cell list against the brute search, ET
molecular dynamics at STMV size through ``md.Simulation`` (Verlet skin, a
cell-list rebuild every 10 steps), and force-loss training of the training
benchmark's ET (8 x 256) through the training CLI
(``torchmdnet_tpu_torch.scripts.train.main``), whose second-order pass runs
the second-order kernel. The same for TensorNet: its three message-phase
kernels against their plain versions (a periodic box, DHFR and training
shapes, and the widths 64 and 96), energy and forces at DHFR size through
``External.calculate`` (bench.py's TensorNet 2 x 128), and force-loss training of
examples/TensorNet-ANI1X.yaml through the CLI, and a DHFR check at weights
where TensorNet's message phase carries at least 10 % of the energy. The
same for the graph network: the ELL gather and its transpose-sum (kernels #4
and #5) against their plain versions, energy and forces at DHFR size
through ``External.calculate`` (6 x 128, bf16 messages), bench.py's
forward with a truncated list at DHFR and STMV size, MD at STMV size, and
force-loss training of GN on aspirin-sized molecules through the CLI; each
training path's gradient with ``remat`` against the one without. The same
for the Transformer: its three edge-phase kernels (#11-#13) against their
plain versions for every distance influence and at the DHFR and training
shapes, energy and forces at DHFR size through ``External.calculate``
(6 x 128, fused bf16), a check at weights where its messages carry at least
10 % of the energy, MD at DHFR size on the fused brute neighbor search
(``neighbor_strategy="brute-pallas"``, kernel #7, which is checked bitwise
against its plain version through ``Potential.neighbors``), and force-loss
training of the training benchmark's shapes (8 x 256) through the CLI. The
output heads and the pair priors: ET energy and forces at DHFR size through
``External.calculate`` with a ZBL prior (whose own cell list runs #6 once
more a call; the prior held against an f64 closed form, and the total
against the model without it plus the prior), ET serving the dipole moment
at ET-QM9's widths (fused against composable, under rotations and a
translation; the other heads and TensorNet's dipole one call each), and
force training with the ZBL, D2 and Coulomb priors through the DataModule,
the loader and the Trainer, with Coulomb's partial charges from the
dataset. The datasets and the reference-checkpoint import:
examples/ET-MD17.yaml at its widths trained through the CLI on an
rMD17-format file read by ``MD17`` (the same frames through ``Custom``'s npy
files equal bitwise), the loader's share of an epoch, and the trained
checkpoint re-expressed in the upstream torchmd-net layout and served back
through ``tools.import_torch.import_checkpoint``, bitwise equal to the port
checkpoint on aspirin frames and at DHFR size. The parallel layer
(``torchmdnet_tpu_torch.parallel``): examples/ET-MD17.yaml through the CLI
on two data-parallel ranks of the one card (gloo), as two nodes through the
environment rendezvous, and on NCCL at world size 1, each against one
process on the same global batches; ET energy and forces edge-partitioned
over two ranks at DHFR size (the fused kernels #1/#2 on each rank's rows)
and at STMV size (each rank's peak memory), and ``Simulation(mesh,
edge_partition=True)`` at DHFR size, each against one process. The training
leftovers: one force-loss step of ET, the Transformer and TensorNet fused
at their training shapes in ``force_grad_mode="jvp"`` against the same step
by grad-of-grad (no second-order launch in jvp mode), examples/ET-MD17.yaml
through the CLI with ``--force-grad-mode jvp``, a third derivative through
each fused family against its plain twin, and a checkpoint written by the
JAX package (tests/data/jax_et.ckpt) served against JAX's energies. The
last leftovers: bench.py's ET and TensorNet STMV MD lines under remat, whose
layers are recomputed in the backward but are served their fused forward
kernel's outputs again instead of launching it (the kernels' launches per
step equal those without remat), each training gradient with remat against
the one without, ``profiling.py``'s trace summary and iteration timer on a
DHFR call, ET-MD17's loader with the native collation against numpy, and
the ET-QM9 dipole at four weight seeds. The published configurations:
bench.py's GN STMV MD line under remat against the same steps without
(forces bitwise), examples/ET-SPICE.yaml and TensorNet-SPICE.yaml (K 128,
forces) and ET-QM9.yaml and TensorNet-QM9.yaml (energies only, Atomref)
through the CLI at their own widths on Custom npy files of seeded
Morse-labelled molecules that this script writes, with #1-#3 and #8-#10
held against their plain versions at the SPICE shapes, and ``optimize()``
serving ET at DHFR size against ``External``. The configurations and
operands it shares with the timing tools are
``torchmdnet_tpu_torch/tools/chip_configs.py``'s. It
times each. Each phase prints one line; the line before the last is a JSON object
with each kernel's numbers, the last line is ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import contextlib
import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(ROOT, "torchmdnet_tpu_torch")):
    sys.exit("chip_smoke: torchmdnet_tpu_torch not found beside chip_smoke.py; run it from a checkout of the "
             "repository")
sys.path.insert(0, ROOT)

# the configurations, batches and kernel operands this script shares with the
# timing tools
from torchmdnet_tpu_torch import profiling  # noqa: E402
from torchmdnet_tpu_torch.tools.chip_configs import (  # noqa: E402
    cell_keys, compaction_shapes, ell_cases, ET_ARGS, GN_ARGS, GN_FWD_ARGS, _gn_lists, GN_MD_EVERY,
    GN_MD_STD, GN_MD_TIMED_STEPS, GN_MD_WARMUP_STEPS, GN_ODD_F, GN_PAIR_F, GN_STMV_FWD_ARGS, GN_TRAIN_ARGS,
    GN_TRAIN_BATCH, GN_TRAIN_LR, GN_TRAIN_MOL, GN_TRAIN_SPLIT, GN_TRAIN_WEIGHTS, _kernel_inputs, MD_ARGS,
    MD_TIMED_STEPS, MD_VALID_EVERY, MD_VALID_STEPS, MD_WARMUP_STEPS, ORDER, SEED, select_cases, _stmv_batch,
    _stmv_kernel_inputs, stmv_skin_keys, _synthetic_batch, T_ARGS, _t_kernel_inputs, T_ORDER, T_TRAIN_ARGS,
    _t_z_like, _three_ways, TN_ARGS, _tn_bwd2_split, _tn_kernel_inputs, TN_ORDER, _tn_pass_split, _tn_system,
    TN_TRAIN_ARGS, TN_TRAIN_BATCH, TN_TRAIN_LR, TN_TRAIN_SPLIT, TN_TRAIN_WEIGHTS, _tn_z_like, TRAIN_ARGS,
    TRAIN_BATCH, _train_batch, _train_dataset, TRAIN_EPOCHS, TRAIN_MOL, TRAIN_SPLIT, TRAIN_TIMED_STEPS,
    TRAIN_WARMUP_STEPS, _z_like, ZBL_CUTOFF,
    COVERED_BY, EXAMPLE_EPOCHS, EXAMPLES, example_flags, GN_REMAT_ARGS, GN_REMAT_STEPS,
    OPT_CALLS, OPT_REBUILD_EVERY, OPT_SKIN, OPT_STEP, QM9_CONFS, QM9_FRAMES, QM9_SIZES, QM9_SPLIT, SPICE_CONFS,
    SPICE_FRAMES, SPICE_SIZES, SPICE_SPLITS, write_custom_frames,
)

FLUSH_KERNELS = profiling.FLUSH_KERNELS
device_ms, enqueue_ms, event_ms = profiling.device_ms, profiling.enqueue_ms, profiling.event_ms
host_ms, kernel_profile = profiling.host_ms, profiling.kernel_profile

REQUESTS = 5

# Kernel against plain version, normalised as max|kernel - plain| / max|plain|.
# Forward: both sides round the same bf16 intermediates at the same points
# (the JAX kernel's discipline) and differ only in the order of f32 sums and
# in libm's last bits, which can flip a bf16 rounding: 2e-3, half a bf16 ulp.
FWD_TOL = 2e-3
# Backward: the plain version's gradients come from autograd, which rounds its
# bf16 intermediates at other points than the kernel does (the kernel follows
# the JAX backward kernel); chains of up to six bf16 products (2^-9 relative
# rounding each) feed every cotangent, then K-slot sums.  2e-2.
BWD_TOL = 2e-2
# Second order: the plain version is autograd's double backward of the plain
# forward, which rounds every bf16 intermediate of the first-order graph and
# of its derivative (chains of up to ten bf16 products, 2^-9 relative each,
# then K-slot sums); the kernel keeps its tangents and cotangents in f32 and
# rounds only the forward's values and the filter operands of its tensor-core
# products.  Measured on the card at N=512, K=41, H=64: at most 9.7e-3.  3e-2.
BWD2_TOL = 3e-2
# Main path, fused bf16 messages against the composable fp32 path with the
# same weights: bf16 carries 8 significant bits through six layers.  Measured
# on the CPU at 400 atoms: energy 2e-4 relative, forces 6e-3 relative L2 and
# 7e-3 max|dF|/max|F|.  Bounds with headroom for the larger system:
E2E_ENERGY_TOL = 2e-3  # |dE| / |E|
E2E_FORCE_TOL = 3e-2  # max|dF| / max|F|

# Force-loss training: the parameter gradients of one step, fused bf16 against
# composable fp32 with the same weights, per parameter tensor as
# max|dg| / max|g|, and over all parameters as |dg| / |g|.  bf16 messages
# carry 8 significant bits through eight layers, and the force loss
# differentiates them twice; tests/test_et_fused.py holds one layer to 4e-2
# of each leaf's max.  Eight layers: 1e-1 per tensor, 5e-2 over all.
TRAIN_GRAD_TOL = 1e-1
TRAIN_GRAD_L2_TOL = 5e-2
# The same gradient with remat: the recomputation replays the same launches
# on the same inputs, so only the order in which autograd adds up a
# parameter's contributions may differ (f32 rounding).  1e-5 of each
# tensor's largest value.
REMAT_TOL = 1e-5


# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12
# int32 compare/select/min outside the tensor cores: the f32 peak counts an
# FMA as two operations on 128 f32 lanes per SM; an SM has 64 int32 lanes,
# one operation each, so a quarter of it
INT32_CUDA_CORE_OPS = F32_CUDA_CORE_FLOPS / 4

# cutoff-boundary pairs between the brute search (|xi|^2 + |xj|^2 - 2 xi.xj)
# and the cell list (component form) may differ where d^2 is within this many
# f32 ulps of the cutoff^2: the two forms round differently
BOUNDARY_ULPS = 4


# (host clock, the line's first words) of every line this script prints: the
# run's longest stretches are printed at the end, to see where its time goes
_LINE_TIMES = []


def log(line):
    _LINE_TIMES.append((time.perf_counter(), line[:56]))
    print(line, flush=True)










# The backward's and second order's helper kernels (the source passes,
# et_dw_kernel) against their plain versions on the same inputs (the
# receiver passes' outputs), as max|kernel - plain| / max|plain|.  Source
# passes: both sides round at the same points, but the f32 order of the
# filter products and the kernels' fast exp can flip a bf16 rounding of a
# filter, which the per-edge chains carry into a term before the K-slot sum
# (as BWD_TOL): 2e-2.  The weight reduction: the same bf16 operands summed
# in f32 in another order: 1e-4.
PART_TOL = 2e-2
WGRAD_TOL = 1e-4


def _call(fn, nbl, ins, heads):
    return fn(nbl.idx, *[ins[n] for n in ORDER], heads=heads, perm=nbl.transpose_perm)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def _fmt(d):
    return json.dumps({a: float(f"{b:.3e}") for a, b in d.items()})




def check_bwd2(nbl, ins, cts, heads, seed):
    """Kernel #3 against its plain version: all 16 input gradients and both
    ct gradients.  Returns ({name: rel err}, max abs err)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    args = (nbl.idx, nbl.transpose_perm, [ins[n] for n in ORDER], cts, _z_like(ins, seed))
    got = em.run_bwd2(*args, heads=heads, act="silu", attn_act="silu")
    want = em.et_messages_bwd2_reference(*args, heads=heads, act="silu", attn_act="silu")
    torch.cuda.synchronize()
    names = ORDER + ["ct_x", "ct_vec"]
    got, want = list(got[0]) + list(got[1]), list(want[0]) + list(want[1])
    rel = {nm: _rel(a, b) for nm, a, b in zip(names, got, want)}
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    return rel, err


def check_kernels(label, n_atoms, k, h, heads, rbf, cutoff, seed, batch=None):
    """Kernels vs plain versions: forward outputs, all 16 input cotangents
    (weight cotangents from the backward kernel's partials), and the second
    order's 16 + 2 gradients (a third derivative: ``third_derivative_probes``)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    nbl, ins, cts = _kernel_inputs(n_atoms, k, h, rbf, cutoff, seed, batch=batch)
    grads = {}
    outs = {}
    for name, fn in (("kernel", em.fused_et_messages), ("plain", em.et_messages_reference)):
        t = {n: v.clone().requires_grad_(n != "msk") for n, v in ins.items()}
        x, vec = _call(fn, nbl, t, heads)
        loss = (x * cts[0]).sum() + (vec * cts[1]).sum()
        names = [n for n in ORDER if n != "msk"]
        g = torch.autograd.grad(loss, [t[n] for n in names])
        torch.cuda.synchronize()
        outs[name] = (x.detach(), vec.detach())
        grads[name] = dict(zip(names, g))
        # msk is 0/1 data: neither side gives it a cotangent (the 16th slot)
        grads[name]["msk"] = torch.zeros_like(ins["msk"])
    bwd2, bwd2_abs = check_bwd2(nbl, ins, cts, heads, seed)
    parts = check_parts(nbl, ins, cts, heads, seed)
    fwd = {nm: _rel(a, b) for nm, a, b in zip(("x_agg", "vec_agg"), outs["kernel"], outs["plain"])}
    bwd = {nm: _rel(grads["kernel"][nm], grads["plain"][nm]) for nm in ORDER}
    fwd_abs = max(float((a - b).abs().max()) for a, b in zip(outs["kernel"], outs["plain"]))
    bwd_abs = max(float((grads["kernel"][n].float() - grads["plain"][n].float()).abs().max()) for n in ORDER)
    n, kk = nbl.idx.shape
    log(f"kernel check {label} (N={n} K={kk} H={h} heads={heads} RBF={rbf}): "
        f"fwd max rel err {max(fwd.values()):.3e} (tol {FWD_TOL}) {_fmt(fwd)}; "
        f"bwd max rel err {max(bwd.values()):.3e} (tol {BWD_TOL}) {_fmt(bwd)}; "
        f"bwd2 max rel err {max(bwd2.values()):.3e} (tol {BWD2_TOL}) {_fmt(bwd2)}; "
        f"helper kernels against their plain versions {_fmt(parts)} (source passes tol {PART_TOL}, "
        f"weight reduction tol {WGRAD_TOL})")
    if max(fwd.values()) > FWD_TOL:
        raise AssertionError(f"forward kernel disagrees with the plain version at {label}: {fwd}")
    if max(bwd.values()) > BWD_TOL:
        raise AssertionError(f"backward kernel disagrees with the plain version at {label}: {bwd}")
    if max(bwd2.values()) > BWD2_TOL:
        raise AssertionError(f"second-order kernel disagrees with the plain version at {label}: {bwd2}")
    if max(v for k, v in parts.items() if "src" in k) > PART_TOL or \
            max(v for k, v in parts.items() if "dw" in k) > WGRAD_TOL:
        raise AssertionError(f"a helper kernel disagrees with its plain version at {label}: {parts}")
    return fwd_abs, bwd_abs, bwd2_abs


def check_parts(nbl, ins, cts, heads, seed):
    """The source passes (et_bwd_src_kernel, et_bwd2_src_kernel) and the
    weight reduction (et_dw_kernel) against their plain versions, fed the
    receiver kernels' outputs: {name: max rel err}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    kw = dict(heads=heads, act="silu", attn_act="silu")
    a = [ins[n] for n in ORDER]
    ops, dirs, w = a[:9], tuple(a[9:12]), a[12:]
    recv = em.bwd_receiver(nbl.idx, *ops, dirs, *w, cts[0], cts[1], want_dpre=True, **kw)
    hs, dpre = recv[4], recv[5]
    src_args = (nbl.idx, nbl.transpose_perm, *ops, dirs, *w, cts[0], cts[1], hs)
    got = em.bwd_source(*src_args, **kw)
    want = em.bwd_source_reference(*src_args[:9], ops[8], dirs, *w, cts[0], cts[1], hs, heads=heads, act="silu")
    rel = {"bwd_src": max(_rel(x, y) for x, y in zip(got, want))}
    pairs = [(ins["ea"].reshape(-1, ins["ea"].shape[-1]), dpre)]
    rel["bwd_dw"] = _rel(em.weight_grads(pairs, ins["ea"].shape[-1]),
                         em.weight_grads_reference(pairs, ins["ea"].shape[-1]))
    z = _z_like(ins, seed)
    recv2 = em.bwd2_receiver(nbl.idx, a, cts, z, **kw)
    hs4, bpre, bpret = recv2[7], recv2[8], recv2[9]
    got = em.bwd2_source(nbl.idx, nbl.transpose_perm, a, cts, z, hs4, **kw)
    want = em.bwd2_source_reference(nbl.idx, nbl.transpose_perm, a, cts, z, hs4, heads=heads, act="silu")
    rel["bwd2_src"] = max(_rel(x, y) for x, y in zip(got, want))
    pairs = [(ins["ea"].reshape(-1, ins["ea"].shape[-1]), bpre), (z[6].reshape(bpre.shape[0], -1), bpret)]
    rel["bwd2_dw"] = _rel(em.weight_grads(pairs, ins["ea"].shape[-1]),
                          em.weight_grads_reference(pairs, ins["ea"].shape[-1]))
    torch.cuda.synchronize()
    return rel


def _bounds(n, kk, h, rbf, kind):
    """Least time for the same work: max(bytes / HBM rate, operations / peak).

    ``kind``: "fwd", "bwd" (frozen weights), "bwd_w" (with weight
    cotangents) or "bwd2" (the second order).  Bytes: each input read once,
    each output written once.  Operations: the filter products (2 * RBF * 4H
    flops per edge each) at the bf16 tensor-core peak: one forward, two
    backward (recompute, d ea), three with weight cotangents (+ ea^T . d_pre),
    seven for the second order (ea.W, z_ea.W, ea.Z_W, two for g ea, two for
    g W); the elementwise work at the f32 CUDA-core peak, counted from the
    kernels' arithmetic: ~46 H flops per edge forward, ~3x that backward,
    ~160 H second order (the dual forward with the activations' first and
    second derivatives, its reverse, four head sums and five channel sums).
    """
    e = n * kk
    f = 4 * h
    filt = 2 * (rbf * f + f)  # filters (bf16)
    in_bytes = (4 * e  # idx
                + 2 * (8 * n * h)  # q, k, v (3H), vec0..2 in bf16
                + 2 * e * rbf  # ea
                + 4 * 5 * e  # cutm, msk, dir0..2
                + filt)
    mm_one = 2 * e * rbf * f
    if kind == "fwd":
        nbytes = in_bytes + 4 * 4 * n * h  # x_agg, vec_agg in f32
        mm, ew = mm_one, 46 * h * e
    elif kind in ("bwd", "bwd_w"):
        nbytes = (in_bytes + 4 * 4 * n * h  # ct_x, ct_vec
                  + 4 * e  # perm
                  + 2 * 8 * n * h  # dq, dk, dv, dvec0..2 (bf16)
                  + 2 * e * rbf + 4 * 4 * e)  # dea, dcutm, ddir0..2
        mm, ew = 2 * mm_one, 3 * 46 * h * e + 7 * h * e
        if kind == "bwd_w":
            nbytes += filt  # the weight cotangents
            mm += mm_one
    else:
        nbytes = (in_bytes + 4 * 4 * n * h + 4 * e  # ct, perm
                  + 2 * 8 * n * h + 2 * e * rbf + 4 * 4 * e + filt  # Z on the backward's outputs
                  + 2 * 8 * n * h + 2 * e * rbf + 4 * 5 * e + filt  # g_inputs (msk's included)
                  + 4 * 4 * n * h)  # g_ct
        mm, ew = 7 * mm_one, 160 * h * e
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mm / BF16_TENSOR_FLOPS + ew / F32_CUDA_CORE_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _resource_parts(km, names, shapes):
    """Each of a kernel module's backward and second-order kernels'
    resources (registers and spills from the compiled code, shared memory
    and resident blocks per SM from the CUDA runtime's occupancy
    calculator) at each shape."""
    parts = []
    for label, (n, k, h, heads, rbf) in shapes:
        for kind, name in names.items():
            r = km.kernel_resources(kind, n, k, h, heads, rbf)
            parts.append(f"{name} at {label} H={h}: {r['registers']} registers, {r['spill_bytes']} B spilled, "
                         f"{r['threads']} threads, {r['smem']} B shared, {r['blocks_per_sm']} blocks/SM "
                         f"({r['blocks_per_sm'] * r['threads'] // 32} warps)")
    return parts


def _resource_shapes(a):
    return (("DHFR", (2496, 81, 128, 8, 50)),
            ("training", (2304, 33, a["embedding_dimension"], a["num_heads"], a["num_rbf"])))


def log_et_resources():
    """The ET kernels' resources at the DHFR, training and STMV skin shapes
    (the weight reduction's with and without TensorNet's bias sums)."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    names = {6: "et_fwd_kernel", 1: "et_bwd_kernel", 2: "et_bwd2_kernel", 3: "et_bwd_src_kernel",
             4: "et_bwd2_src_kernel", 5: "et_dw_kernel", 7: "et_dw_kernel with bias sums"}
    shapes = _resource_shapes(TRAIN_ARGS) + (("STMV skin", (30336, 112, 128, 8, 50)),)
    log("ET kernel resources: " + "; ".join(_resource_parts(em, names, shapes)))


def log_tn_resources():
    """The TensorNet forward's kernel at the DHFR and training shapes (K = 65
    and 33, H = 128, RBF = 32), at 64 RBFs and at the narrow checks' widths;
    the backward's at the DHFR and training shapes; the second order's at the
    training shapes, at 64 RBFs and at the narrow widths.  The weight
    reduction is ET's et_dw_kernel, whose resources do not depend on the
    shape (log_et_resources)."""
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    h, rbf = TN_ARGS["embedding_dimension"], TN_ARGS["num_rbf"]
    dhfr = (2496, TN_ARGS["max_num_neighbors"] + 1)
    train = (TN_TRAIN_BATCH * TRAIN_MOL["num_atoms"], TN_TRAIN_ARGS["max_num_neighbors"] + 1)
    shapes = ((0, "DHFR", dhfr, h, rbf), (0, "training", train, h, rbf), (0, "training", train, h, TN_WIDE_RBF))
    shapes += tuple((0, "training", train, w, rbf) for w in TN_NARROW_WIDTHS)
    shapes += ((1, "DHFR", dhfr, h, rbf), (1, "training", train, h, rbf),
               (2, "training", train, h, rbf), (2, "training", train, h, TN_WIDE_RBF))
    shapes += tuple((2, "training", train, w, rbf) for w in TN_NARROW_WIDTHS)
    parts = []
    for kind, label, (n, k), w, nr in shapes:
        r = tm.kernel_resources(n, k, w, nr, kind=kind)
        parts.append(f"{('tn_fwd_kernel', 'tn_bwd_kernel', 'tn_bwd2_kernel')[kind]} at {label} N={n} K={k} H={w} "
                     f"RBF={nr}: "
                     f"{r['registers']} registers, {r['spill_bytes']} B spilled, {r['threads']} threads, "
                     f"{r['smem']} B shared, {r['blocks_per_sm']} blocks/SM "
                     f"({r['blocks_per_sm'] * r['threads'] // 32} warps)")
    log("TensorNet kernel resources: " + "; ".join(parts))


def log_t_resources():
    """The Transformer forward's, backward's and second order's passes'
    resources at the DHFR and training shapes (the weight reduction is ET's
    et_dw_kernel)."""
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    names = {5: "t_fwd_kernel", 1: "t_bwd_kernel", 2: "t_bwd2_kernel", 3: "t_bwd_src_kernel",
             4: "t_bwd2_src_kernel"}
    log("Transformer kernel resources: " + "; ".join(
        _resource_parts(tmk, names, _resource_shapes(T_TRAIN_ARGS))))


# #1 and #2 at the STMV skin list against their plain versions: the
# forward's plain version runs over chunks of this many receiver rows; the
# backward's on the cotangents of this many atoms drawn at random
STMV_CHECK_ROWS = 4096
STMV_CHECK_ATOMS = 384


def _no_perm():
    raise AssertionError("a forward over a chunk of rows needs no transpose permutation")


def _max_rel(pairs):
    """max|kernel - plain| / max|plain| over (kernel, plain) chunks of one output."""
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    return diff / max(max(float(b.float().abs().max()) for _, b in pairs), 1e-30)


def check_stmv(nbl, ins, cts, heads, seed):
    """#1 and #2 (frozen weights, as MD runs it) at the STMV skin list
    against their plain versions, which take the whole list at once beyond
    the card's memory.  The forward: every receiver row, the plain version
    over chunks of STMV_CHECK_ROWS rows (their slots gather from all atoms).
    The backward: the cotangents of STMV_CHECK_ATOMS random atoms S;
    receiver side (dq, dea, dcutm, ddir) from autograd through the plain
    version of S's rows, source side (dk, dv, dvec) from autograd through
    the K edges pointing at each atom of S (``transpose_perm``'s groups, in
    slot order), each edge a row of an identity list, summed per atom in
    f32.  Returns ({output: max rel err}, max abs err of the forward, of
    the backward); raises past FWD_TOL or BWD_TOL."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    kw = dict(heads=heads, act="silu", attn_act="silu")
    idx, perm = nbl.idx, nbl.transpose_perm
    n, kk = idx.shape
    w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]
    src_names = ("k", "v", "vec0", "vec1", "vec2")
    row_names = ("q", "ea", "cutm", "msk", "dir0", "dir1", "dir2")
    common = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
    x, vec = em.run_fwd(idx, *common, dirs, *w, **kw)
    fwd = {"x_agg": [], "vec_agg": []}
    for r0 in range(0, n, STMV_CHECK_ROWS):
        r = slice(r0, min(n, r0 + STMV_CHECK_ROWS))
        rows = {x_: ins[x_][r] for x_ in row_names}
        px, pv = em.et_messages_reference(
            idx[r], rows["q"], *[ins[x_] for x_ in src_names], rows["ea"], rows["cutm"], rows["msk"],
            rows["dir0"], rows["dir1"], rows["dir2"], *w, perm=_no_perm, **kw)
        fwd["x_agg"].append((x[r], px))
        fwd["vec_agg"].append((vec[r], pv))
    fwd_abs = max(float((a - b).abs().max()) for p_ in fwd.values() for a, b in p_)
    rel = {f"fwd_{k_}": _max_rel(v_) for k_, v_ in fwd.items()}
    del x, vec, fwd

    got = em.run_bwd(idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=False, **kw)
    got = dict(zip(("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "dir0", "dir1", "dir2"), got))
    g = torch.Generator().manual_seed(seed)
    atoms = torch.randperm(n, generator=g)[:STMV_CHECK_ATOMS].sort().values.to(idx.device)
    # receiver side: the rows of S
    t = {x_: ins[x_][atoms].clone().requires_grad_(x_ != "msk") for x_ in row_names}
    px, pv = em.et_messages_reference(
        idx[atoms], t["q"], *[ins[x_] for x_ in src_names], t["ea"], t["cutm"], t["msk"],
        t["dir0"], t["dir1"], t["dir2"], *w, perm=_no_perm, **kw)
    leaves = [x_ for x_ in row_names if x_ != "msk"]
    want = dict(zip(leaves, torch.autograd.grad((px, pv), [t[x_] for x_ in leaves],
                                                 (cts[0][atoms], cts[1][atoms]))))
    # source side: the K edges pointing at each atom of S, one a row
    edges = perm.reshape(n, kk)[atoms].reshape(-1).long()
    recv, m = torch.div(edges, kk, rounding_mode="floor"), edges.numel()
    if not torch.equal(idx.reshape(-1)[edges].reshape(-1, kk)[:, 0], atoms):
        raise AssertionError("transpose_perm's groups do not point at their atoms")
    ident = torch.arange(m, dtype=torch.int32, device=idx.device)
    s_ = {x_: ins[x_][atoms].repeat_interleave(kk, dim=0).clone().requires_grad_() for x_ in src_names}
    e_ = {x_: ins[x_].reshape(n * kk, *ins[x_].shape[2:])[edges].reshape(m, 1, *ins[x_].shape[2:])
          for x_ in ("ea", "cutm", "msk", "dir0", "dir1", "dir2")}
    px, pv = em.et_messages_reference(
        ident.reshape(m, 1), ins["q"][recv], *[s_[x_] for x_ in src_names], e_["ea"], e_["cutm"], e_["msk"],
        e_["dir0"], e_["dir1"], e_["dir2"], *w, perm=ident, **kw)
    gs = torch.autograd.grad((px, pv), [s_[x_] for x_ in src_names], (cts[0][recv], cts[1][recv]))
    for x_, gx in zip(src_names, gs):
        want[x_] = gx.to(torch.promote_types(gx.dtype, torch.float32)).reshape(len(atoms), kk, -1).sum(1)
    bwd_abs = 0.0
    for x_, b in want.items():
        a = got[x_][atoms]
        rel[f"bwd_{x_}"] = _rel(a, b)
        bwd_abs = max(bwd_abs, float((a.float() - b.float()).abs().max()))
    torch.cuda.synchronize()
    log(f"kernel check at the STMV skin list (N={n} K={kk} H={ins['q'].shape[1]} heads={heads} "
        f"RBF={ins['ea'].shape[-1]}; #1 on every row in chunks of {STMV_CHECK_ROWS}, #2 frozen on {len(atoms)} "
        f"random atoms, both sides): fwd max rel err {max(v_ for k_, v_ in rel.items() if 'fwd' in k_):.3e} "
        f"(tol {FWD_TOL}), bwd max rel err {max(v_ for k_, v_ in rel.items() if 'bwd' in k_):.3e} "
        f"(tol {BWD_TOL}) {_fmt(rel)}")
    if max(v_ for k_, v_ in rel.items() if "fwd" in k_) > FWD_TOL:
        raise AssertionError(f"forward kernel disagrees with the plain version at the STMV skin list: {rel}")
    if max(v_ for k_, v_ in rel.items() if "bwd" in k_) > BWD_TOL:
        raise AssertionError(f"backward kernel disagrees with the plain version at the STMV skin list: {rel}")
    return rel, fwd_abs, bwd_abs


def time_kernels(seed):
    """Each kernel's time at the DHFR shapes, its plain version's, its bound;
    #1 and #2 at the STMV skin list checked against their plain versions
    (``check_stmv``) and timed."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    nbl, ins, cts = _kernel_inputs(2489, ET_ARGS["max_num_neighbors"], 128, 50, 5.0, seed)
    heads = ET_ARGS["num_heads"]
    n, kk = nbl.idx.shape
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
    common = [ins[n] for n in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    w = [ins[n] for n in ("wdk", "bdk", "wdv", "bdv")]
    perm = nbl.transpose_perm
    kw = dict(heads=heads, act="silu", attn_act="silu")
    fwd_ms = event_ms(lambda: em.run_fwd(nbl.idx, *common, dirs, *w, **kw), flush=flush)
    bwd_ms = event_ms(lambda: em.run_bwd(
        nbl.idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=False, **kw), flush=flush)
    bwd_w_ms = event_ms(lambda: em.run_bwd(
        nbl.idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=True, **kw), flush=flush)
    plain_fwd_ms = event_ms(lambda: _call(em.et_messages_reference, nbl, ins, heads), flush=flush)
    t = {n: v.clone().requires_grad_(n in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "dir0", "dir1", "dir2"))
         for n, v in ins.items()}
    x, vec = _call(em.et_messages_reference, nbl, t, heads)
    leaves = [v for v in t.values() if v.requires_grad]
    plain_bwd_ms = event_ms(
        lambda: torch.autograd.grad((x, vec), leaves, cts, retain_graph=True), flush=flush)
    fb, fby = _bounds(n, kk, 128, 50, "fwd")
    bb, bby = _bounds(n, kk, 128, 50, "bwd")
    bwb, bwby = _bounds(n, kk, 128, 50, "bwd_w")
    del x, vec, t, leaves
    # #2 at ET MD's STMV skin list (no weight cotangents: MD freezes them)
    snbl, sins, scts = _stmv_kernel_inputs(seed)
    sn, skk = snbl.idx.shape
    _, stmv_fwd_abs, stmv_bwd_abs = check_stmv(snbl, sins, scts, heads, seed)
    scommon = [sins[n] for n in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    sdirs, sw = (sins["dir0"], sins["dir1"], sins["dir2"]), [sins[n] for n in ("wdk", "bdk", "wdv", "bdv")]
    stmv_ms = event_ms(lambda: em.run_bwd(
        snbl.idx, snbl.transpose_perm, *scommon, sdirs, *sw, scts[0], scts[1], want_weight_grads=False, **kw),
        flush=flush, reps=5)
    stmv_fwd_ms = event_ms(lambda: em.run_fwd(snbl.idx, *scommon, sdirs, *sw, **kw), flush=flush, reps=5)
    sb, sby = _bounds(sn, skk, 128, 50, "bwd")
    sfb, sfby = _bounds(sn, skk, 128, 50, "fwd")
    del snbl, sins, scts, scommon, sdirs, sw
    log(f"kernel times at DHFR shapes (N={n} K={kk} H=128 RBF=50, L2 flushed, median of 20): "
        f"fwd {fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f} ms, bound {fb:.4f} ms by {fby}); "
        f"bwd {bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f} ms, bound {bb:.4f} ms by {bby}); "
        f"bwd with weight cotangents {bwd_w_ms:.4f} ms (bound {bwb:.4f} ms by {bwby}); "
        f"at the STMV skin shape (N={sn} K={skk}, median of 5): fwd {stmv_fwd_ms:.4f} ms (bound {sfb:.4f} ms "
        f"by {sfby}), bwd {stmv_ms:.4f} ms (bound {sb:.4f} ms by {sby})")
    return dict(fwd=(fwd_ms, plain_fwd_ms, fb, fby), bwd=(bwd_ms, plain_bwd_ms, bb, bby),
                stmv_fwd=(stmv_fwd_ms, sfb), stmv_bwd=(stmv_ms, sb), stmv_abs=(stmv_fwd_abs, stmv_bwd_abs))


# launches of the ET and Transformer backward's and second order's helper
# kernels (source passes, weight reduction) on each of their main paths, by
# path name, filled as the paths run
PART_LAUNCHES = {}


def _check_et_parts(path, bwd, bwd2):
    """Each backward launch ran one source pass, each second-order launch
    one (counted since the last reset); records the helpers' launches."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    parts = {"et_message_bwd_src": em.bwd_source.launches, "et_message_bwd2_src": em.bwd2_source.launches,
             "et_message_dw": em.weight_grads.launches}
    if (parts["et_message_bwd_src"], parts["et_message_bwd2_src"]) != (bwd, bwd2):
        raise AssertionError(f"{path}: expected {bwd} + {bwd2} source-pass launches, got {parts}")
    PART_LAUNCHES[path] = parts
    return parts


def _check_t_parts(path, bwd, bwd2):
    """The Transformer's: each #12 launch ran one source pass, each #13
    launch one; the weight reductions are ET's kernel (et_dw_kernel, counted
    by its wrapper), which only the Transformer runs on its paths."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    parts = {"t_message_bwd_src": tmk.bwd_source.launches, "t_message_bwd2_src": tmk.bwd2_source.launches,
             "t_message_dw": em.weight_grads.launches}
    if (parts["t_message_bwd_src"], parts["t_message_bwd2_src"]) != (bwd, bwd2):
        raise AssertionError(f"{path}: expected {bwd} + {bwd2} Transformer source-pass launches, got {parts}")
    PART_LAUNCHES[path] = parts
    return parts


def _check_tn_parts(path, least, most):
    """TensorNet's weight reduction (et_dw_kernel, once per #9 launch that
    wants the weights' cotangents and once per #10 launch) ran between
    ``least`` and ``most`` times since the last reset; records it."""
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    parts = {"tn_message_dw": tm.weight_grads.launches}
    if not least <= parts["tn_message_dw"] <= most:
        raise AssertionError(f"{path}: expected {least} to {most} TensorNet weight-reduction launches, got {parts}")
    PART_LAUNCHES[path] = parts
    return parts


def main_path(args, km, label):
    """Energy + forces of ``args``' model for the DHFR-sized system through
    External.calculate; ``km`` is the model's kernel module, whose forward
    and backward must run once per layer per call."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch import External, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    z, pos, _ = _synthetic_batch(DHFR_ATOMS, SEED, "cpu")
    potential = create_model(args, seed=SEED)  # on cuda: no device named
    ext = External((potential, None), z[None])
    rng = np.random.default_rng(SEED)
    requests = [pos + rng.normal(scale=0.02, size=pos.shape).astype(np.float32) for _ in range(REQUESTS - 1)]
    requests.append(requests[-1].copy())  # the last request repeats the one before

    _reset_launches()
    results = []
    for p in requests:
        energy, forces = ext.calculate(p)
        results.append((energy.clone(), forces.clone()))
    torch.cuda.synchronize()
    launches = (km.run_fwd.launches, km.run_bwd.launches, select_topk.launches)
    layers = args["num_layers"]
    for energy, forces in results:
        if energy.shape != (1,) or forces.shape != (1, DHFR_ATOMS, 3):
            raise AssertionError(f"unexpected shapes {tuple(energy.shape)}, {tuple(forces.shape)}")
        if not (torch.isfinite(energy).all() and torch.isfinite(forces).all()):
            raise AssertionError("non-finite energy or forces")
    # one cell-list build per request, one more for the first request's capacity check
    if launches != (layers * REQUESTS, layers * REQUESTS, REQUESTS + 1):
        raise AssertionError(f"expected {layers} fwd + {layers} bwd launches per request and "
                             f"{REQUESTS + 1} select_topk launches, got {launches}")
    if args["model"] == "equivariant-transformer":
        _check_et_parts("external_dhfr", launches[1], 0)
    elif args["model"] == "transformer":
        _check_t_parts("t_external_dhfr", launches[1], 0)
    elif args["model"] == "tensornet":
        _check_tn_parts("tn_external_dhfr", 0, 0)  # serving freezes the weights
    if not torch.equal(results[-1][1], results[-2][1]):
        raise AssertionError("forces of two identical requests differ")

    # the same weights through the composable fp32 path
    ref = create_model(dict(args, bf16_messages=False, fused_attention=False, fused_message=False), seed=SEED)
    ref.module.load_state_dict(potential.module.state_dict())
    ref_ext = External((ref, None), z[None])
    e32, f32 = ref_ext.calculate(requests[0])
    e_err = float((results[0][0] - e32).abs().max() / e32.abs().max())
    f_err = float((results[0][1] - f32).abs().max() / f32.abs().max())
    f_l2 = float((results[0][1] - f32).norm() / f32.norm())
    log(f"main path: {REQUESTS} requests, {label} bf16, {DHFR_ATOMS} atoms (padded to "
        f"{ext.n_real + ext.n_pad}); launches fwd {launches[0]} bwd {launches[1]} "
        f"({layers}+{layers} per request), select_topk {launches[2]}; energies {[round(float(r[0][0]), 4) for r in results]}; "
        f"repeat forces bitwise equal: True; vs composable fp32: |dE|/|E| {e_err:.3e} (tol {E2E_ENERGY_TOL}), "
        f"max|dF|/max|F| {f_err:.3e} (tol {E2E_FORCE_TOL}), |dF|/|F| {f_l2:.3e}")
    if e_err > E2E_ENERGY_TOL or f_err > E2E_FORCE_TOL:
        raise AssertionError("bf16 energies/forces disagree with the composable fp32 path")
    share = None
    if args["model"] in ("tensornet", "transformer"):
        # how much of the output the message phase carries at these weights:
        # the composable fp32 model with every message zeroed (TensorNet:
        # each interaction's last MLP layer, silu(0) = 0; the Transformer:
        # the value projection)
        with torch.no_grad():
            if args["model"] == "transformer":
                _zero_t_messages(ref.module.representation_model)
            else:
                for layer in ref.module.representation_model.layers:
                    layer.linears_scalar[2].weight.zero_()
                    layer.linears_scalar[2].bias.zero_()
        e0, f0 = External((ref, None), z[None]).calculate(requests[0])
        share = float((e0 - e32).abs().max() / e32.abs().max())
        log(f"{label}: the message phase carries |dE|/|E| {share:.3e} "
            f"and max|dF|/max|F| {float((f0 - f32).abs().max() / f32.abs().max()):.3e} of the composable "
            f"fp32 output (messages zeroed)")
        ref.module.load_state_dict(potential.module.state_dict())

    fused_ms = host_ms(lambda: ext.calculate(requests[0]))
    comp_ms = host_ms(lambda: ref_ext.calculate(requests[0]))
    log(f"{label} energy+forces per call (External.calculate, host clock with sync, median of 20): "
        f"bf16 {fused_ms:.3f} ms; composable fp32 {comp_ms:.3f} ms")
    return launches, ext, requests[0], fused_ms, share


def _shares(groups, other, busy):
    parts = [f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in groups.items()]
    return ", ".join(parts + [f"other kernels {other:.3f} ms ({100 * other / busy:.1f}%)"])


ET_SERVE_KERNELS = ("et_fwd_kernel", "et_bwd_kernel", "et_bwd_src_kernel")
TN_SERVE_KERNELS = ("tn_fwd_kernel", "tn_bwd_kernel")


def profile_calls(ext, pos, names, label, calls=3):
    """Where the time of an energy+forces call goes: device time by kernel
    against the host clock."""
    wall, busy, groups, other, launches, _ = kernel_profile(lambda: ext.calculate(pos), calls, names)
    log(f"profile of {calls} {label} calls (torch.profiler): wall {wall:.3f} ms/call, device busy "
        f"{busy:.3f} ms/call ({100 * busy / wall:.1f}%); {_shares(groups, other, busy)} "
        f"({launches:.0f} other launches/call)")










def _unique_keys(rng, n, w, sentinel, invalid_share):
    """(n, w) int32 keys, unique per row below ``sentinel``, a share of them
    replaced by the sentinel."""
    import numpy as np

    keys = np.argsort(rng.random((n, sentinel)), axis=1)[:, :w].astype(np.int32)
    keys[rng.random((n, w)) < invalid_share] = sentinel
    return keys


def check_select_topk(path_cases):
    """Kernel #6 against its plain version, one case for each keys-per-lane
    rung the kernel compiles and each edge of its threshold search: a ragged
    case (W not a multiple of 32, N not a multiple of the rows per block,
    rows with fewer real keys than k, an all-sentinel row), the DHFR build's
    keys at the default cell capacity, a capacity of up to 75, a row wider
    than the register budget, rows with exactly k real keys under a
    power-of-two sentinel, keys 0 and sentinel - 1 beside k = W, and each
    path's own build (``path_cases``: label -> (keys, k, sentinel); the STMV
    skin build's among them).  Integers: bitwise equal."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.cell_list import cell_candidate_keys
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk, select_topk_reference

    rng = np.random.default_rng(3)
    ragged = _unique_keys(rng, 1001, 45, 5000, 0.3)
    ragged[5] = 5000
    ragged[6, 3:] = 5000
    _, _, dhfr = _synthetic_batch(DHFR_ATOMS, SEED, "cuda")
    dhfr_keys, _, overflow = cell_candidate_keys(dhfr.pos, dhfr.batch, dhfr.atom_mask,
                                                 cutoff_upper=ET_ARGS["cutoff_upper"])
    if bool(overflow):
        raise AssertionError("the DHFR build overflowed the default cell sizes")
    cap66 = _unique_keys(rng, 500, 27 * 66, 5000, 0.6)
    wide = _unique_keys(rng, 37, 2100, 5000, 0.5)
    # exactly k = 64 real keys a row (the threshold a real key, no sentinel
    # selected) under the power-of-two sentinel 4096 (a 12- or 13-bit search)
    exact = np.full((333, 27 * 19), 4096, dtype=np.int32)
    for i in range(exact.shape[0]):
        exact[i, rng.choice(exact.shape[1], 64, replace=False)] = rng.choice(4096, 64, replace=False)
    # every row holds 0 and sentinel - 1; k = W takes both and every sentinel slot
    ends = _unique_keys(rng, 257, 100, 3000, 0.5)
    ends[:, 0], ends[:, 99] = 0, 2999
    ends[:, 1:99][(ends[:, 1:99] == 0) | (ends[:, 1:99] == 2999)] = 3000
    cases = [("ragged", torch.as_tensor(ragged, device="cuda"), 20, 5000),
             ("DHFR build", dhfr_keys, ET_ARGS["max_num_neighbors"], dhfr_keys.shape[0]),
             ("capacity 66", torch.as_tensor(cap66, device="cuda"), 112, 5000),
             ("wide", torch.as_tensor(wide, device="cuda"), 50, 5000),
             ("exactly k real keys, sentinel 4096", torch.as_tensor(exact, device="cuda"), 64, 4096),
             ("keys 0 and sentinel - 1, k = W", torch.as_tensor(ends, device="cuda"), 100, 3000),
             ("keys 0 and sentinel - 1, k = 7", torch.as_tensor(ends, device="cuda"), 7, 3000)]
    cases += [(label, kk, k_sel, sentinel) for label, (kk, k_sel, sentinel) in path_cases.items()]
    parts = []
    err = 0
    for label, kk, k_sel, sentinel in cases:
        got = select_topk(kk, k_sel, sentinel)
        want = select_topk_reference(kk, k_sel)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"select_topk disagrees with its plain version on {label}: {bad} rows")
        err = max(err, int((got.long() - want.long()).abs().max()))
        parts.append(f"{label} N={kk.shape[0]} W={kk.shape[1]} k={k_sel}: equal")
    log("select_topk check (kernel vs plain, bitwise): " + "; ".join(parts))
    return err


def log_select_topk_resources(path_cases):
    """The selection kernel's resources at each path's build (its rung of
    keys per lane, its shared memory for k)."""
    from torchmdnet_tpu_torch.ops.kernels.select_topk import kernel_resources

    parts = []
    for label, (keys, k, _) in path_cases.items():
        r = kernel_resources(keys.shape[1], k)
        parts.append(f"{label} W={keys.shape[1]} k={k}: {r['registers']} registers, {r['spill_bytes']} B spilled, "
                     f"{r['threads']} threads, {r['smem']} B shared, {r['blocks_per_sm']} blocks/SM "
                     f"({r['blocks_per_sm'] * r['threads'] // 32} warps)")
    log("select_topk_kernel resources: " + "; ".join(parts))


def check_cell_vs_brute(n_atoms):
    """The cell list against the brute search on the card at the cutoff and k
    of ET_ARGS: equal idx, mask and n_neighbors, except rows touched by pairs
    whose squared distance lies within BOUNDARY_ULPS f32 ulps of cutoff^2."""
    import torch

    from torchmdnet_tpu_torch.ops.neighbors import neighbor_list

    _, _, batch = _synthetic_batch(n_atoms, SEED, "cuda")
    cut = ET_ARGS["cutoff_upper"]
    kw = dict(k=ET_ARGS["max_num_neighbors"], cutoff_upper=cut, loop=True)
    cell = neighbor_list(batch.pos, batch.batch, batch.atom_mask, strategy="cell", **kw)
    brute = neighbor_list(batch.pos, batch.batch, batch.atom_mask, strategy="brute", **kw)
    if bool(cell.cell_overflow) or bool(cell.overflow()):
        raise AssertionError(f"the cell list overflowed at {n_atoms} atoms")
    n = batch.pos.shape[0]

    def pairs(nbl):
        adj = torch.zeros((n, n), dtype=torch.bool, device="cuda")
        rows = torch.arange(n, device="cuda")[:, None].expand_as(nbl.idx)
        adj[rows[nbl.mask], nbl.idx[nbl.mask].long()] = True
        return adj

    cell_only = pairs(cell) & ~pairs(brute)
    brute_only = pairs(brute) & ~pairs(cell)
    diff = (cell_only | brute_only).nonzero()
    if diff.numel():
        d = batch.pos[diff[:, 1]] - batch.pos[diff[:, 0]]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        c2 = torch.tensor(cut * cut, dtype=torch.float32)
        ulp = float(torch.nextafter(c2, torch.tensor(math.inf)) - c2)
        far = (d2 - float(c2)).abs() > BOUNDARY_ULPS * ulp
        if bool(far.any()):
            raise AssertionError(f"{int(far.sum())} pairs differ between the cell list and brute "
                                 f"away from the cutoff at {n_atoms} atoms")
    touched = torch.zeros(n, dtype=torch.bool, device="cuda")
    touched[diff[:, 0]] = True
    same = ~touched
    if not (torch.equal(cell.idx[same], brute.idx[same]) and torch.equal(cell.mask[same], brute.mask[same])
            and torch.equal(cell.n_neighbors[same], brute.n_neighbors[same])):
        raise AssertionError(f"the cell list and brute differ in rows without boundary pairs at {n_atoms} atoms")
    dn = cell_only.sum(dim=1) - brute_only.sum(dim=1)
    if not torch.equal((cell.n_neighbors - brute.n_neighbors).long(), dn):
        raise AssertionError("n_neighbors differences do not match the boundary pairs")
    build_ms = {
        strategy: host_ms(lambda: neighbor_list(batch.pos, batch.batch, batch.atom_mask, strategy=strategy, **kw))
        for strategy in ("brute", "cell")
    }
    log(f"cell list vs brute at {n_atoms} atoms (N={n}, K={cell.k}, cutoff {cut}): idx, mask, n_neighbors "
        f"equal; {diff.shape[0] // 2} cutoff-boundary pairs differ (within {BOUNDARY_ULPS} ulps of "
        f"cutoff^2), {int(touched.sum())} rows touched; cell_overflow False; build time (host clock "
        f"with sync, median of 20) brute {build_ms['brute']:.3f} ms, cell {build_ms['cell']:.3f} ms")


def _select_topk_bounds(keys, k, sentinel):
    """Least time for the selection: max(bytes / HBM rate, operations / int32
    peak).  Bytes: the keys read once, the output written once.  Operations:
    what the function needs, one per key (a radix select looks at each key a
    bounded number of times).  Also returns what this kernel's design does,
    as a note: per row, a compare and an add per key for the count of real
    keys and, where a row has k or more, for each step of the threshold
    search (32 - clz(sentinel - the row's minimum) steps), one operation per
    key for the compaction, and a compare and an add of each kept key
    against every other for the ranks, at the int32 peak."""
    import torch

    n, w = keys.shape
    top = sentinel - keys.min(dim=1).values.long()
    bits = torch.where(top > 0, torch.floor(torch.log2(top.double().clamp(min=1))) + 1, torch.zeros_like(top.double()))
    real = (keys < sentinel).sum(dim=1)
    steps = 1 + bits * (real >= k).double()
    m = real.clamp(max=k).double()
    design_ops = float((2 * steps * w).sum() + n * w + (2 * m * m).sum())
    t_bytes = (4 * n * w + 4 * n * k) / HBM_BYTES_PER_S
    t_ops = n * w / INT32_CUDA_CORE_OPS
    bound = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return bound + (design_ops, 1e3 * design_ops / INT32_CUDA_CORE_OPS)


def time_select_topk(cases):
    """Kernel #6 at each path's build (``cases``: label -> (keys, k,
    sentinel)): its time, the plain version's, one torch.topk call's, and
    the bound (L2 flushed, median of 20).  Returns {label: (ms, plain_ms,
    bound_ms, bound_by, library_ms)}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk, select_topk_reference

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    out, parts = {}, []
    for label, (keys, k, sentinel) in cases.items():
        ms = event_ms(lambda: select_topk(keys, k, sentinel), flush=flush)
        plain_ms = event_ms(lambda: select_topk_reference(keys, k), flush=flush)
        lib_ms = event_ms(lambda: torch.topk(keys, k, dim=1, largest=False, sorted=True), flush=flush)
        bound_ms, bound_by, design_ops, design_ms = _select_topk_bounds(keys, k, sentinel)
        out[label] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        parts.append(f"{label} N={keys.shape[0]} W={keys.shape[1]} k={k}: {ms:.4f} ms (plain sort {plain_ms:.4f} ms, "
                     f"torch.topk {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                     f"{100 * bound_ms / ms:.1f}% of it reached; this design's search, compaction and ranks do "
                     f"{design_ops:.3e} int32 operations, {design_ms:.4f} ms at the int32 peak)")
    log("select_topk times (L2 flushed, median of 20): " + "; ".join(parts))
    return out


def _pairs_against_fresh(sim, model, batch, built_at, args=ET_ARGS):
    """The skin list built at ``built_at`` and refined at ``sim``'s current
    positions against a fresh list built there (``args``' cutoffs), as sets
    of (atom, neighbor) pairs: (pairs only the fresh list holds, pairs only
    the refined list holds, the fresh list's pairs)."""
    import torch

    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    hi = args["cutoff_upper"]
    pos = sim.state.pos
    n = batch.num_atoms
    skin_nbl = sim._build_nbl(built_at)
    refined = skin_nbl.refine(pos, args["cutoff_lower"], hi)
    fresh = model.neighbors(batch.replace(pos=pos), k=skin_nbl.k - int(skin_nbl.self_loops),
                            **probe_cell_kwargs(batch, cutoff_upper=hi))
    fresh.raise_on_overflow("chip_smoke fresh STMV list")

    def pairs(nbl):
        rows = torch.arange(n, device=pos.device)[:, None].expand_as(nbl.idx)
        return (rows * n + nbl.idx.long())[nbl.mask]

    r, f = pairs(refined), pairs(fresh)
    return int((~torch.isin(f, r)).sum()), int((~torch.isin(r, f)).sum()), int(f.numel())


def md_stmv(select_ms):
    """ET molecular dynamics at STMV size through md.Simulation.

    1. bench.py's configuration: warm-up, timed steps, every kernel's
       launches; ``stale`` must agree with the largest displacement between
       rebuilds seen from the host.  The fastest atoms' thermal speed at
       300 K times 10 fs exceeds skin/2, so these lists do go stale; the
       pairs the last refined list misses against a fresh one are counted.
    2. A rebuild cadence at which the skin holds (MD_VALID_EVERY): two
       Simulations from the same batch and seed end bitwise equal, ``stale``
       stays False, and the last skin list, refined at the final positions,
       holds exactly the pairs of a fresh list built there.
    """
    import torch

    from torchmdnet_tpu_torch import Simulation, create_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    batch = _stmv_batch()
    real = batch.atom_mask
    n = batch.num_atoms
    torch.cuda.reset_peak_memory_stats()
    model = create_model(ET_ARGS, seed=SEED)
    every = MD_ARGS["rebuild_every"]
    half_skin = 0.5 * MD_ARGS["neighbor_skin"]

    def largest_move(starts, end):
        ends = starts[1:] + [end]
        return max(float((b - a).norm(dim=-1)[real].max()) for a, b in zip(starts, ends))

    sim = Simulation(model, batch, seed=SEED, **MD_ARGS)
    sim.set_velocities_from_temperature(300.0)
    v_max = float(sim.state.vel.norm(dim=-1)[real].max())
    em.reset_launch_counts()
    select_topk.launches = 0
    starts = []
    for _ in range(MD_WARMUP_STEPS // every):
        starts.append(sim.state.pos)
        sim.step(every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MD_TIMED_STEPS // every):
        starts.append(sim.state.pos)
        sim.step(every)
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / MD_TIMED_STEPS
    launches = (em.run_fwd.launches, em.run_bwd.launches, select_topk.launches)

    steps = MD_WARMUP_STEPS + MD_TIMED_STEPS
    rebuilds = steps // every
    evaluations = steps + 1  # one per step, carried across chunks, plus the first
    layers = ET_ARGS["num_layers"]
    if launches != (layers * evaluations, layers * evaluations, rebuilds):
        raise AssertionError(f"expected {layers}+{layers} ET launches per force evaluation "
                             f"({evaluations}) and one select_topk per rebuild ({rebuilds}), got {launches}")
    _check_et_parts("md_stmv", launches[1], 0)
    state = sim.state
    if not (torch.isfinite(state.pos).all() and torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite positions or energies in MD")
    if not torch.equal(state.pos[~real], batch.pos[~real]):
        raise AssertionError("padding atoms moved")
    move = largest_move(starts, state.pos)
    stale = bool(state.stale)
    if move > half_skin and not stale:
        raise AssertionError(f"atoms moved {move:.3f} A between rebuilds (> skin/2) but stale is False")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    missed, extra, total = _pairs_against_fresh(sim, model, batch, starts[-1])

    rebuild_ms = host_ms(lambda: sim._build_nbl(state.pos).transpose_perm, reps=5, warmup=0)
    log(f"MD at STMV size, bench.py's configuration (ET {layers}x{ET_ARGS['embedding_dimension']} fused "
        f"bf16, {int(real.sum())} atoms padded to {n}, {MD_ARGS}, cell sizes {sim.neighbor_kwargs}): "
        f"{steps} steps, energy {float(state.energy.sum()):.4f} eV, padding still; launches fwd "
        f"{launches[0]} bwd {launches[1]} select_topk {launches[2]} ({evaluations} force evaluations, "
        f"{rebuilds} rebuilds); {ms_step:.3f} ms/step (host clock with sync, mean of {MD_TIMED_STEPS}); "
        f"neighbor rebuild {rebuild_ms:.3f} ms (cell list + select_topk + transpose permutation, median "
        f"of 5), select_topk {100 * select_ms / rebuild_ms:.1f}% of it; peak memory {peak_gb:.2f} GiB; "
        f"largest move between rebuilds {move:.3f} A against skin/2 = {half_skin} A: stale {stale}; "
        f"initial max speed {v_max:.4f} A/fs, x {every} fs = {v_max * every * MD_ARGS['timestep_fs']:.3f} A; "
        f"at the last step the refined skin list misses {missed} of a fresh list's {total} pairs "
        f"({extra} it holds that a fresh list does not)")
    if extra:
        raise AssertionError(f"the refined skin list holds {extra} pairs that a fresh list does not")

    valid = dict(MD_ARGS, rebuild_every=MD_VALID_EVERY)
    runs = []
    for _ in range(2):
        run = Simulation(model, batch, seed=SEED, **valid)
        run.set_velocities_from_temperature(300.0)
        vstarts = []
        for _ in range(MD_VALID_STEPS // MD_VALID_EVERY):
            vstarts.append(run.state.pos)
            run.step(MD_VALID_EVERY)
        runs.append((run, vstarts))
    (a, vstarts), (b, _) = runs
    if not torch.equal(a.state.pos, b.state.pos):
        raise AssertionError("two Simulations from the same batch and seed diverged")
    vmove = largest_move(vstarts, a.state.pos)
    if bool(a.state.stale):
        raise AssertionError(f"the skin list went stale at rebuild_every={MD_VALID_EVERY} (move {vmove:.3f} A)")
    if _pairs_against_fresh(a, model, batch, vstarts[-1])[:2] != (0, 0):
        raise AssertionError("the refined skin list and a fresh list hold different pairs")
    log(f"MD at STMV size, rebuild every {MD_VALID_EVERY}: {MD_VALID_STEPS} steps, largest move between "
        f"rebuilds {vmove:.3f} A, stale False, two runs from one seed bitwise equal, the refined skin "
        f"list holds exactly a fresh list's pairs")
    del runs, a, b
    return launches, sim, ms_step, peak_gb


def profile_md(sim, names=ET_SERVE_KERNELS, label="ET", steps=5):
    """Where the time of an MD step goes at STMV: device time by kernel over
    ``steps`` steps."""
    names = names + ("select_topk_kernel",)
    wall, busy, groups, other, _, _ = kernel_profile(lambda: sim.step(steps), 1, names)
    wall, busy, other = wall / steps, busy / steps, other / steps
    groups = {k: v / steps for k, v in groups.items()}
    log(f"profile of {steps} {label} MD steps at STMV (torch.profiler): wall {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step ({100 * busy / wall:.1f}%); {_shares(groups, other, busy)}")


def _gn_km():
    """GN's kernels in the shape of a fused kernel module: #4 counts as its
    forward, #5 as its backward; it has no second-order kernel."""
    import types

    from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg

    return types.SimpleNamespace(run_fwd=eg.gather_rows, run_bwd=eg.transpose_sum_rows,
                                 run_bwd2=types.SimpleNamespace(launches=0))


def _train_cfg(kind):
    """A training path's configuration: "et" (benchmarks/training.py's ET),
    "t" (the same with --model transformer), "tn"
    (examples/TensorNet-ANI1X.yaml) or "gn" (BASELINE.json's GN on
    aspirin).  ``per_step``/``per_eval``: launches of (fwd, bwd, bwd2) per
    layer in a training step and in an evaluation batch."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    fused = dict(mol=TRAIN_MOL, per_step=(1, 2, 1), per_eval=(1, 1, 0))
    if kind == "et":
        return dict(fused, args=TRAIN_ARGS, batch=TRAIN_BATCH, split=TRAIN_SPLIT, km=em, lr=1e-4,
                    weights=(1.0, 1.0), label=f"ET {TRAIN_ARGS['num_layers']}x{TRAIN_ARGS['embedding_dimension']}",
                    kernels=("et_fwd_kernel", "et_bwd_kernel", "et_bwd2_kernel", "et_bwd_src_kernel",
                             "et_bwd2_src_kernel", "et_dw_kernel"),
                    flags=["--num-heads", str(TRAIN_ARGS["num_heads"]), "--neighbor-embedding", "true",
                           "--fused-attention", "true"])
    if kind == "t":
        return dict(fused, args=T_TRAIN_ARGS, batch=TRAIN_BATCH, split=TRAIN_SPLIT, km=tmk, lr=1e-4,
                    weights=(1.0, 1.0),
                    label=f"Transformer {T_TRAIN_ARGS['num_layers']}x{T_TRAIN_ARGS['embedding_dimension']}",
                    kernels=T_KERNELS,
                    flags=["--num-heads", str(T_TRAIN_ARGS["num_heads"]), "--neighbor-embedding", "true",
                           "--fused-attention", "true"])
    if kind == "tn":
        return dict(fused, args=TN_TRAIN_ARGS, batch=TN_TRAIN_BATCH, split=TN_TRAIN_SPLIT, km=tm,
                    lr=TN_TRAIN_LR, weights=TN_TRAIN_WEIGHTS, label="TensorNet-ANI1X 2x128",
                    kernels=("tn_fwd_kernel", "tn_bwd_kernel", "tn_bwd2_kernel", "tn_src_sum_kernel",
                             "et_dw_kernel"),
                    flags=["--equivariance-invariance-group", TN_TRAIN_ARGS["equivariance_invariance_group"],
                           "--fused-message", "true"])
    # a force-loss step gathers twice per layer (the forward and the outer
    # pass through the inner transpose) and transposes twice (the inner
    # force pass and the outer energy term)
    return dict(args=GN_TRAIN_ARGS, batch=GN_TRAIN_BATCH, split=GN_TRAIN_SPLIT, km=_gn_km(), lr=GN_TRAIN_LR,
                weights=GN_TRAIN_WEIGHTS, label="GN-aspirin 6x128", mol=GN_TRAIN_MOL,
                per_step=(2, 2, 0), per_eval=(1, 1, 0), kernels=GN_KERNELS,
                flags=["--neighbor-embedding", "true", "--aggr", GN_TRAIN_ARGS["aggr"]])






def _launches(km):
    """(fwd, bwd, bwd2, select_topk) launches of a kernel module."""
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    return (km.run_fwd.launches, km.run_bwd.launches, km.run_bwd2.launches, select_topk.launches)


def _reset_launches():
    from torchmdnet_tpu_torch.ops.kernels import compaction
    from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    em.reset_launch_counts()
    tm.reset_launch_counts()
    tmk.reset_launch_counts()
    eg.reset_launch_counts()
    compaction.reset_launch_counts()
    select_topk.launches = 0


def time_train_kernels(batch, label="the training shapes", args=TRAIN_ARGS, kinds=("fwd", "bwd", "bwd_w", "bwd2")):
    """#1, #2 (with and without weight cotangents) and #3 at the training
    shapes (N=2304, K=33, H=256, 8 heads, RBF=64; or ``batch``'s N and
    ``args``' widths), their plain versions and bounds (L2 flushed, median
    of 20); ``kinds`` names the ones to time."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    h, heads, rbf = args["embedding_dimension"], args["num_heads"], args["num_rbf"]
    nbl, ins, cts = _kernel_inputs(None, args["max_num_neighbors"], h, rbf,
                                   args["cutoff_upper"], SEED, batch=batch)
    n, kk = nbl.idx.shape
    perm = nbl.transpose_perm
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
    common = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]
    kw = dict(heads=heads, act="silu", attn_act="silu")
    z = _z_like(ins, SEED)
    inputs = [ins[x] for x in ORDER]
    calls = dict(
        fwd=lambda: em.run_fwd(nbl.idx, *common, dirs, *w, **kw),
        bwd=lambda: em.run_bwd(nbl.idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=False, **kw),
        bwd_w=lambda: em.run_bwd(nbl.idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=True, **kw),
        bwd2=lambda: em.run_bwd2(nbl.idx, perm, inputs, cts, z, **kw),
    )
    ms = {k: event_ms(calls[k], flush=flush) for k in kinds}
    t = {x: v.clone().requires_grad_(x != "msk") for x, v in ins.items()}
    x_out, vec_out = _call(em.et_messages_reference, nbl, t, heads)
    leaves = [t[x] for x in ORDER if x != "msk"]
    plain_calls = dict(
        fwd=lambda: event_ms(lambda: _call(em.et_messages_reference, nbl, ins, heads), flush=flush),
        bwd_w=lambda: event_ms(lambda: torch.autograd.grad((x_out, vec_out), leaves, cts, retain_graph=True),
                               flush=flush),
        bwd2=lambda: event_ms(lambda: em.et_messages_bwd2_reference(nbl.idx, perm, inputs, cts, z, **kw),
                              flush=flush, reps=5),
    )
    plain = {k: plain_calls[k]() for k in kinds if k in plain_calls}
    bounds = {k: _bounds(n, kk, h, rbf, k) for k in ms}
    log(f"kernel times at {label} (N={n} K={kk} H={h} heads={heads} RBF={rbf}, L2 flushed, "
        f"median of 20; plain second order of 5): "
        + "; ".join(f"{k} {v:.4f} ms (bound {bounds[k][0]:.4f} ms by {bounds[k][1]}"
                    + (f", plain {plain[k]:.4f} ms" if k in plain else "") + ")" for k, v in ms.items()))
    return ms, plain, bounds


def train_grads_vs_composable(ds, cfg, batch=None, remat=True, grads_out=None):
    """One training gradient at a training configuration (the force loss, or
    the energy loss where ``derivative`` is false), fused bf16 against
    composable fp32 with the same weights, on ``batch`` (by default the first
    molecules of ``ds``); the fused pass must run ``per_step`` launches per
    layer (L forward, 2L backward and L second order for ET and TensorNet's
    force loss).  Then (``remat``) the same gradient with remat (each layer
    recomputed in the backward pass) must equal it (H2-REMAT): for the fused
    families with the same launches as without remat, each layer's
    recomputations served the forward kernel's outputs by replay
    (``save_list``: L replays in each of the two backward passes); GN's
    layers are recomputed whole, its gathers launched again, as in JAX.
    ``grads_out`` (a dict) receives the fused gradients by parameter name.
    Returns the remat gradient's (fwd, bwd, bwd2) launches (None without
    ``remat``)."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.kernels import save_list
    from torchmdnet_tpu_torch.train.trainer import masked_mse

    args = cfg["args"]
    if batch is None:
        batch = _train_batch(ds, "cuda", cfg["batch"], args["cutoff_upper"], cfg["mol"])
    fused = create_model(args, seed=SEED)
    comp = create_model(dict(args, bf16_messages=False, fused_attention=False, fused_message=False), seed=SEED)
    comp.module.load_state_dict(fused.module.state_dict())
    models = [("fused", fused), ("composable", comp)]
    if remat:
        models.append(("remat", create_model(dict(args, remat=True), seed=SEED)))
        models[-1][1].module.load_state_dict(fused.module.state_dict())
    wy, wf = cfg["weights"]
    grads, launches, remat_launches, replays, peaks = {}, None, None, None, {}
    for name, model in models:
        _reset_launches()
        save_list.reset_replays()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nbl = model.neighbors(batch)
        nbl.raise_on_overflow("the training batch")
        if args["derivative"]:
            y, neg_dy = model.energy_and_forces(batch, nbl=nbl, create_graph=True)
            loss = (wy * masked_mse(y, batch.y, batch.mol_mask)
                    + wf * masked_mse(neg_dy, batch.neg_dy, batch.atom_mask))
        else:
            loss = wy * masked_mse(model.energy(batch, nbl=nbl), batch.y, batch.mol_mask)
        names = [k for k, p in model.module.named_parameters() if p.requires_grad]
        g = torch.autograd.grad(loss, [dict(model.module.named_parameters())[k] for k in names])
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        grads[name] = dict(zip(names, g))
        del loss, nbl
        if name == "fused":
            launches = _launches(cfg["km"])[:3]
        elif name == "remat":
            remat_launches, replays = _launches(cfg["km"])[:3], dict(save_list.replays)
    layers = args["num_layers"]
    expected = tuple(c * layers for c in cfg["per_step"])
    if launches != expected:
        raise AssertionError(f"one fused training gradient should launch (fwd, bwd, bwd2) {expected}, "
                             f"got {launches}")
    fused_family = args["model"] != "graph-network"
    kernel = f"{cfg['km'].__name__.split('.')[-1]}_fwd" if fused_family else None
    if remat and fused_family and (remat_launches != launches or replays != {kernel: 2 * layers}):
        raise AssertionError(f"with remat the gradient launched {remat_launches} (without: {launches}) and "
                             f"replayed {replays} (expected {{{kernel!r}: {2 * layers}}})")
    remat_err = max(_rel(grads["remat"][k], v) for k, v in grads["fused"].items()) if remat else None
    per = {k: _rel(grads["fused"][k], v) for k, v in grads["composable"].items()}
    num = sum(float((grads["fused"][k].double() - v.double()).pow(2).sum()) for k, v in grads["composable"].items())
    den = sum(float(v.double().pow(2).sum()) for v in grads["composable"].values())
    l2 = math.sqrt(num / den)
    worst = max(per, key=per.get)
    what = "force-loss" if args["derivative"] else "energy-loss"
    log(f"{what} gradient at the training configuration ({cfg['label']}, {batch.num_mol} molecules, "
        f"N={batch.num_atoms}, K={args['max_num_neighbors']}): launches fwd {launches[0]} bwd {launches[1]} "
        f"bwd2 {launches[2]} ({cfg['per_step']} x L for L={layers}); fused bf16 vs composable fp32 over "
        f"{len(per)} parameter tensors: max|dg|/max|g| worst {per[worst]:.3e} ({worst}, tol {TRAIN_GRAD_TOL}), "
        f"median {statistics.median(per.values()):.3e}; |dg|/|g| {l2:.3e} (tol {TRAIN_GRAD_L2_TOL}); peak "
        f"above what each found allocated: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items())
        + ("" if not remat else f"; with remat (H2-REMAT), max|dg|/max|g| {remat_err:.3e} from the gradient "
           f"without (tol {REMAT_TOL}), launches {remat_launches}, replays {replays}"))
    if per[worst] > TRAIN_GRAD_TOL or l2 > TRAIN_GRAD_L2_TOL:
        raise AssertionError(f"fused {what} gradients disagree with the composable fp32 path")
    if remat and remat_err > REMAT_TOL:
        raise AssertionError(f"the {what} gradient with remat differs from the one without: {remat_err}")
    if grads_out is not None:
        grads_out.update(grads["fused"])
    del grads, models, fused, comp
    return remat_launches


def _cli_flags(workdir, cfg):
    a = cfg["args"]
    train, val, test = cfg["split"]
    wy, wf = cfg["weights"]
    return [
        "--model", a["model"], "--embedding-dimension", str(a["embedding_dimension"]),
        "--num-layers", str(a["num_layers"]), "--num-rbf", str(a["num_rbf"]),
        "--max-num-neighbors", str(a["max_num_neighbors"]),
        "--cutoff-upper", str(a["cutoff_upper"]), "--max-z", str(a["max_z"]),
        "--derivative", "true", "--bf16-messages", "true", *cfg["flags"],
        "--lr", str(cfg["lr"]), "--batch-size", str(cfg["batch"]), "--num-epochs", str(TRAIN_EPOCHS),
        "--train-size", str(train), "--val-size", str(val), "--test-size", str(test),
        "--y-weight", str(wy), "--neg-dy-weight", str(wf), "--seed", str(SEED),
        "--dataset", "SyntheticMorse", "--dataset-root", os.path.join(workdir, "data"),
        "--dataset-arg", json.dumps(dict(num_samples=sum(cfg["split"]), seed=SEED, **cfg["mol"])),
        "--log-dir", os.path.join(workdir, "logs"), "--save-interval", "1", "--num-workers", "0",
    ]


def _check_reload(trainer):
    """The best checkpoint of ``trainer`` reloads through ``load_model``
    with the weights it holds, its optimizer state, and the model's mean and
    std.  Returns the checkpoint's path."""
    import torch

    from torchmdnet_tpu_torch.models.potential import load_model
    from torchmdnet_tpu_torch.train.checkpoints import load_checkpoint

    best = trainer.best_model_path
    ckpt = load_checkpoint(best)
    reloaded = load_model(best)
    same = all(torch.equal(v.cpu(), ckpt["state_dict"][k]) for k, v in reloaded.module.state_dict().items())
    scale = (trainer.model.module.mean, trainer.model.module.std)
    if not same or ckpt["optimizer"] is None or (reloaded.module.mean, reloaded.module.std) != scale:
        raise AssertionError(f"the checkpoint {best} did not reload")
    return best


def train_cli(workdir, cfg):
    """Force-loss training through the CLI's entry point: losses finite and
    falling, the expected launches, a checkpoint written and reloadable."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as et_kernels
    from torchmdnet_tpu_torch.ops.kernels import t_message as t_kernels
    from torchmdnet_tpu_torch.scripts import train as cli

    t0 = time.perf_counter()
    _reset_launches()
    trainer, test_metrics = cli.main(_cli_flags(workdir, cfg))
    torch.cuda.synchronize()
    launches = _launches(cfg["km"])
    seconds = time.perf_counter() - t0
    with open(os.path.join(workdir, "logs", "metrics.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r.get("train_total_mse_loss")]
    train_losses = [float(r["train_total_mse_loss"]) for r in rows]
    first = trainer.first_step_loss
    values = train_losses + [first] + [float(v) for v in test_metrics.values()]
    if len(rows) != TRAIN_EPOCHS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"training losses missing or not finite: {rows}, {test_metrics}")
    if not train_losses[-1] < first:
        raise AssertionError(f"the last epoch's train loss {train_losses[-1]} is not below the first "
                             f"step's {first}")
    layers = cfg["args"]["num_layers"]
    split, bs = cfg["split"], cfg["batch"]
    steps = TRAIN_EPOCHS * (split[0] // bs)
    evals = TRAIN_EPOCHS * -(-split[1] // bs) + -(-split[2] // bs)
    expected = tuple(layers * (s * steps + e * evals) for s, e in zip(cfg["per_step"], cfg["per_eval"])) + (0,)
    if launches != expected or trainer.state.global_step != steps:
        raise AssertionError(f"expected launches {expected} for {steps} steps and {evals} evaluation "
                             f"batches, got {launches} after {trainer.state.global_step} steps")
    if cfg["km"] is et_kernels:
        if _check_et_parts("train", launches[1], launches[2])["et_message_dw"] < launches[2]:
            raise AssertionError("the second order's weight reduction did not run once per launch")
    elif cfg["km"] is t_kernels:
        if _check_t_parts("t_train", launches[1], launches[2])["t_message_dw"] < launches[2]:
            raise AssertionError("the Transformer second order's weight reduction did not run once per launch")
    elif cfg["args"]["model"] == "tensornet":
        _check_tn_parts("tn_train", launches[2], launches[1] + launches[2])
    best = _check_reload(trainer)
    log(f"training CLI (scripts.train.main, {cfg['label']} fused bf16, SyntheticMorse {cfg['mol']}, "
        f"{split} samples, batches of {bs}, {TRAIN_EPOCHS} epochs = {steps} steps): "
        f"first step loss {first:.4f}, epoch train losses {[round(v, 4) for v in train_losses]}, "
        f"test {json.dumps({k: round(v, 4) for k, v in test_metrics.items()})}; launches fwd {launches[0]} "
        f"bwd {launches[1]} bwd2 {launches[2]} select_topk {launches[3]} ({steps} steps x {cfg['per_step']} x L + "
        f"{evals} evaluation batches x {cfg['per_eval']} x L, L={layers}); checkpoint {os.path.basename(best)} "
        f"reloads with its optimizer state; {seconds:.1f} s in all (dataset and model setup included)")
    return trainer, launches


def time_train_steps(trainer, ds, cfg, batch=None):
    """Trainer steps on one training batch (``batch``, by default the first
    molecules of ``ds``): host clock with sync around each step, median
    after warm-up; ``per_step`` launches per layer and step, and the peak."""
    import torch

    if batch is None:
        batch = trainer._prepare_batch(_train_batch(ds, "cpu", cfg["batch"], cfg["args"]["cutoff_upper"], cfg["mol"]))
    bs = batch.num_mol
    acc = torch.zeros(4, dtype=trainer.dtype, device="cuda")
    ema = torch.zeros((), dtype=trainer.dtype, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP_STEPS):
        trainer._train_step(batch, acc, ema, ema)
    _reset_launches()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._train_step(batch, acc, ema, ema)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    launches = _launches(cfg["km"])[:3]
    layers = cfg["args"]["num_layers"]
    if launches != tuple(c * layers * TRAIN_TIMED_STEPS for c in cfg["per_step"]):
        raise AssertionError(f"expected {cfg['per_step']} x L launches per step, got {launches} in "
                             f"{TRAIN_TIMED_STEPS} steps")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"training step (Trainer, {cfg['label']} fused bf16, {bs} molecules, {int(batch.atom_mask.sum())} atoms "
        f"padded to N={batch.num_atoms}, host clock with sync, median of {TRAIN_TIMED_STEPS} after "
        f"{TRAIN_WARMUP_STEPS}): {ms:.3f} ms/step "
        f"(min {min(times):.3f}, max {max(times):.3f}), {1e3 * bs / ms:.1f} molecules/s; launches "
        f"per step fwd {launches[0] // TRAIN_TIMED_STEPS} bwd {launches[1] // TRAIN_TIMED_STEPS} bwd2 "
        f"{launches[2] // TRAIN_TIMED_STEPS}; peak memory {peak:.2f} GiB")
    return batch, ms


def profile_train(trainer, batch, cfg, steps=2):
    """Where the time of a training step goes: device time by kernel
    against the host clock."""
    import torch

    acc = torch.zeros(4, dtype=trainer.dtype, device="cuda")
    ema = torch.zeros((), dtype=trainer.dtype, device="cuda")
    wall, busy, groups, other, launches, _ = kernel_profile(
        lambda: trainer._train_step(batch, acc, ema, ema), steps, cfg["kernels"])
    log(f"profile of {steps} {cfg['label']} training steps (torch.profiler): wall {wall:.3f} ms/step, device "
        f"busy {busy:.3f} ms/step ({100 * busy / wall:.1f}%); {_shares(groups, other, busy)} "
        f"({launches:.0f} other launches/step)")


# --- TensorNet: serving at DHFR size and force-loss training ----------------

# TensorNet's forward, kernel against plain version: both round at the same
# points, but the edge MLP chains three layers, and the order of a layer's
# f32 sums can flip the bf16 rounding of a pre-activation in each of them
# (one ulp, 2^-8 relative), where ET's filter has one layer.  Measured on the
# card: 1.07e-3 at N = 512, K = 81 and 2.29e-3 at DHFR (K = 65), with the
# backward and second order, which recompute the same forward, at 7e-3 of
# their 2e-2 and 3e-2.  So 5e-3, with a second check that the kernel is no
# farther than twice the plain version's distance from the same function in
# f32 without intermediate rounding.
TN_FWD_TOL = 5e-3
# the narrow checks: widths below TN_ARGS's 128 that the kernels take, on a
# training batch of this many molecules (K = 33)
TN_NARROW_WIDTHS = (64, 96)
TN_NARROW_MOLECULES = 16
TN_WIDE_RBF = 64








def check_tn_kernels(label, kind, seed, h=TN_ARGS["embedding_dimension"], rbf=TN_ARGS["num_rbf"], k=None,
                     cutoff=None):
    """#8, #9 and #10 against their plain versions at width ``h`` and ``rbf``
    RBFs (a training batch's list at ``k`` and ``cutoff``, TensorNet-ANI1X's
    by default): the forward output, all nine input cotangents through
    autograd (the weight cotangents from the edge reductions), the backward
    without weight cotangents (serving's), and the second order's nine + 1
    gradients.  Returns the max abs errors (fwd, bwd, bwd2)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    nbl, pos, box = _tn_system(kind, seed, k=k, cutoff=cutoff)
    cut = TN_ARGS["cutoff_upper"] if cutoff is None else cutoff
    ins, ct = _tn_kernel_inputs(nbl, pos, h, rbf, cut, seed, box=box)
    idx, perm = nbl.idx, nbl.transpose_perm
    outs, grads = {}, {}
    for name, fn in (("kernel", tm.fused_tn_messages), ("plain", tm.tn_messages_reference)):
        t = {n: v.clone().requires_grad_(True) for n, v in ins.items()}
        m = fn(idx, *[t[n] for n in TN_ORDER], act="silu", perm=perm)
        g = torch.autograd.grad(m, [t[n] for n in TN_ORDER], ct)
        torch.cuda.synchronize()
        outs[name], grads[name] = m.detach(), dict(zip(TN_ORDER, g))
    # serving's backward: no weight cotangents, the same input cotangents
    frozen = tm.run_bwd(idx, *[ins[n] for n in TN_ORDER], ct, act="silu", want_weight_grads=False)
    if any(x is not None for x in frozen[3:]):
        raise AssertionError("the backward without weight cotangents returned some")
    for n, a in zip(TN_ORDER[:3], frozen[:3]):
        if not torch.equal(a, grads["kernel"][n]):
            raise AssertionError(f"the backward's {n} cotangent depends on whether weight cotangents are wanted")
    z = _tn_z_like(ins, seed)
    inputs = [ins[n] for n in TN_ORDER]
    got = tm.run_bwd2(idx, perm, inputs, ct, z, act="silu")
    want = tm.tn_messages_bwd2_reference(idx, perm, inputs, ct, z, act="silu")
    torch.cuda.synchronize()
    names = TN_ORDER + ["ct"]
    got, want = list(got[0]) + [got[1]], list(want[0]) + [want[1]]
    bwd2 = {nm: _rel(a, b) for nm, a, b in zip(names, got, want)}
    bwd2_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    parts = check_tn_parts(idx, perm, inputs, ct, z)
    fwd = _rel(outs["kernel"], outs["plain"])
    exact = tm.tn_messages_reference(idx, *[ins[n].float() for n in TN_ORDER], perm=perm)
    k_exact, p_exact = _rel(outs["kernel"], exact), _rel(outs["plain"], exact)
    bwd = {n: _rel(grads["kernel"][n], grads["plain"][n]) for n in TN_ORDER}
    fwd_abs = float((outs["kernel"] - outs["plain"]).abs().max())
    bwd_abs = max(float((grads["kernel"][n].float() - grads["plain"][n].float()).abs().max()) for n in TN_ORDER)
    n, kk = idx.shape
    log(f"TensorNet kernel check {label} (N={n} K={kk} H={h} RBF={rbf}{', periodic box' if box is not None else ''}): "
        f"fwd max rel err {fwd:.3e} (tol {TN_FWD_TOL}; from f32 without intermediate rounding: kernel "
        f"{k_exact:.3e}, plain {p_exact:.3e}); bwd max rel err {max(bwd.values()):.3e} "
        f"(tol {BWD_TOL}) {_fmt(bwd)}; bwd2 max rel err {max(bwd2.values()):.3e} (tol {BWD2_TOL}) "
        f"{_fmt(bwd2)}; weight reduction (et_dw_kernel) against its plain version on #9's and #10's rows "
        f"{_fmt(parts)} (tol {WGRAD_TOL}); frozen-weight backward equal")
    if fwd > TN_FWD_TOL or k_exact > 2 * p_exact:
        raise AssertionError(f"TensorNet forward kernel disagrees with the plain version at {label}: {fwd} "
                             f"(from unrounded f32: kernel {k_exact}, plain {p_exact})")
    if max(bwd.values()) > BWD_TOL:
        raise AssertionError(f"TensorNet backward kernel disagrees with the plain version at {label}: {bwd}")
    if max(bwd2.values()) > BWD2_TOL:
        raise AssertionError(f"TensorNet second-order kernel disagrees with the plain version at {label}: {bwd2}")
    if max(parts.values()) > WGRAD_TOL:
        raise AssertionError(f"TensorNet weight reduction disagrees with its plain version at {label}: {parts}")
    return fwd_abs, bwd_abs, bwd2_abs


def check_tn_parts(idx, perm, inputs, ct, z):
    """TensorNet's weight reduction (et_dw_kernel with the bias sums) against
    its plain version on the rows the backward (#9) and the second order
    (#10) wrote, split as the kernel splits them: {product: max rel err}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    h, rbfp = inputs[0].shape[1] // 9, tm._rbfp(inputs[1].shape[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rel = {}
    for name, rows, jobs in (
            ("bwd", tm.bwd_rows(idx, *inputs, ct, act="silu", want_rows=True)[3], tm._bwd_jobs(h, rbfp)),
            ("bwd2", tm.bwd2_rows(idx, perm, inputs, ct, z, act="silu")[4], tm._bwd2_jobs(h, rbfp))):
        got = tm.weight_grads(rows, jobs)
        want = tm.weight_grads_reference(rows, jobs, tm._per_split(rows.shape[0], jobs, sms))
        for layer, ((gw, gb), (ww, wb)) in enumerate(zip(got, want), 1):
            rel[f"{name}_dw{layer}"] = _rel(gw, ww)
            rel[f"{name}_db{layer}"] = _rel(gb, wb)
    torch.cuda.synchronize()
    return rel


def _tn_bounds(n, kk, h, rbf, kind):
    """Least time for a TensorNet message-phase kernel's work: max(bytes /
    HBM rate, MLP products / bf16 tensor peak + the rest / f32 peak).

    ``kind``: "fwd", "bwd" (frozen weights), "bwd_w" (with weight
    cotangents) or "bwd2".  Bytes: each input read once, each output written
    once.  The edge MLP is 2 * (RBF*H + H*2H + 2H*3H) flops per edge: once in
    the forward; twice in the backward (the recompute and the reverse), three
    times with weight cotangents; eight times in the second order (the
    value, two tangent products per layer, three reverse products per layer
    and two for the weight gradients).  The elementwise work, counted from
    the kernels' arithmetic: ~45 H flops per edge forward (six activations
    per H, the cutoff, nine gathered products and sums), ~150 H backward,
    ~400 H second order (tangents, second derivatives and their reverse).
    """
    e = n * kk
    wts = rbf * h + h + 2 * h * h + 2 * h + 6 * h * h + 3 * h  # MLP weights and biases
    mlp = 2 * (rbf * h + 2 * h * h + 6 * h * h)
    in_bytes = 4 * e + 2 * 9 * h * n + 2 * e * rbf + 4 * e + 2 * wts  # idx, cat, ea, cutm, weights
    grads = 2 * 9 * h * n + 2 * e * rbf + 4 * e  # d_cat, d_ea, d_cutm
    if kind == "fwd":
        nbytes, mm, ew = in_bytes + 4 * 9 * h * n, mlp * e, 45 * h * e
    elif kind in ("bwd", "bwd_w"):
        nbytes, mm, ew = in_bytes + 4 * 9 * h * n + grads, 2 * mlp * e, 150 * h * e
        if kind == "bwd_w":
            nbytes += 4 * wts
            mm += mlp * e
    else:
        nbytes = (in_bytes + 4 * 9 * h * n + 4 * e  # ct, perm
                  + 2 * 9 * h * n + 2 * e * rbf + 4 * e + 2 * wts  # Z
                  + grads + 4 * wts + 4 * 9 * h * n)  # g_inputs, g_ct
        mm, ew = 8 * mlp * e, 400 * h * e
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mm / BF16_TENSOR_FLOPS + ew / F32_CUDA_CORE_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _tn_times(nbl, ins, ct, z, kinds, flush):
    """{kind: (ms, plain ms, bound ms, bound by, (N, K))} of TensorNet's
    kernels on ``ins`` (L2 flushed, median of 20; the plain second order of
    5)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    idx, perm = nbl.idx, nbl.transpose_perm
    n, kk = idx.shape
    h, rbf = ins["cat"].shape[1] // 9, ins["ea"].shape[-1]
    args = [ins[x] for x in TN_ORDER]
    out = {}
    for k in kinds:
        if k == "fwd":
            ms = event_ms(lambda: tm.run_fwd(idx, *args, act="silu"), flush=flush)
            plain = event_ms(lambda: tm.tn_messages_reference(idx, *args, perm=perm), flush=flush)
        elif k in ("bwd", "bwd_w"):
            want = k == "bwd_w"
            ms = event_ms(lambda: tm.run_bwd(idx, *args, ct, act="silu", want_weight_grads=want), flush=flush)
            t = {x: v.clone().requires_grad_(want or x in ("cat", "ea", "cutm")) for x, v in ins.items()}
            m = tm.tn_messages_reference(idx, *[t[x] for x in TN_ORDER], perm=perm)
            leaves = [t[x] for x in TN_ORDER if t[x].requires_grad]
            plain = event_ms(lambda: torch.autograd.grad(m, leaves, ct, retain_graph=True), flush=flush)
            del m, t
        else:
            ms = event_ms(lambda: tm.run_bwd2(idx, perm, args, ct, z, act="silu"), flush=flush)
            plain = event_ms(lambda: tm.tn_messages_bwd2_reference(idx, perm, args, ct, z), flush=flush, reps=5)
        out[k] = (ms, plain) + _tn_bounds(n, kk, h, rbf, k) + ((n, kk),)
    return out


def time_tn_kernels(train_batch):
    """#8 and #9 (frozen weights) at the DHFR serving shapes, #9 with weight
    cotangents and #10 at the training shapes: each kernel's time (L2
    flushed, median of 20), its plain version's and its bound.  No single
    PyTorch call computes the fused phase: no library time."""
    import torch

    h, rbf = TN_ARGS["embedding_dimension"], TN_ARGS["num_rbf"]
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    out = {}
    for where, kind, kinds in (("DHFR", "DHFR", ("fwd", "bwd")), ("training", train_batch, ("fwd", "bwd_w", "bwd2"))):
        nbl, pos, box = _tn_system(kind, SEED)
        ins, ct = _tn_kernel_inputs(nbl, pos, h, rbf, TN_ARGS["cutoff_upper"], SEED, box=box)
        idx, perm = nbl.idx, nbl.transpose_perm
        n, kk = idx.shape
        args = [ins[x] for x in TN_ORDER]
        z = _tn_z_like(ins, SEED)
        for k, row in _tn_times(nbl, ins, ct, z, kinds, flush).items():
            out[(where, k)] = row
        if where == "training":
            split = _tn_pass_split(idx, args, ct, flush)
            split2 = _tn_bwd2_split(idx, perm, args, ct, z, flush)
            log(f"TensorNet passes at training (N={n} K={kk} H={h}; L2 flushed; #9: CUDA events, median of 20: "
                + "; ".join(f"{name} {ms:.4f} ms" for name, ms in split.items())
                + "; #10, each kernel's device time in run_bwd2's calls (torch.profiler, mean of 20): "
                + "; ".join(f"{name} {ms:.4f} ms" for name, ms in split2.items()) + ")")
    log("TensorNet kernel times (L2 flushed, median of 20; plain second order of 5): " + "; ".join(
        f"{k} at {where} N={v[4][0]} K={v[4][1]} {v[0]:.4f} ms (plain {v[1]:.4f} ms, bound {v[2]:.4f} ms by "
        f"{v[3]}, {100 * v[2] / v[0]:.1f}% of it reached)" for (where, k), v in out.items()))
    return out








# --- The graph network: kernels #4/#5, serving, the fp32 forward, STMV MD, training ---

# the reference's published GN forward times (BASELINE.md), taken on a
# desktop NVIDIA GPU, not an H100
REF_GN_FWD_MS = {"DHFR": 27.22, "STMV": 217.72}
GN_FWD_REPS = 10
GN_KERNELS = ("gather_rows_kernel", "transpose_sum_rows_kernel")




def _bf16_ulp(x):
    """The bf16 ulp at |x| (8 significant bits)."""
    import torch

    mag = x.float().abs()
    return torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7)


def _slot_order_sum(ct, perm, k):
    """#5's contract in plain PyTorch: each atom's K slot rows added in f32
    one by one in ascending slot order from 0, rounded once to bf16; and the
    sum of the rows' magnitudes."""
    import torch

    rows = ct.reshape(perm.numel(), -1).index_select(0, perm.long()).reshape(-1, k, ct.shape[-1]).float()
    acc = torch.zeros_like(rows[:, 0])
    for s in range(k):
        acc = acc + rows[:, s]
    return acc.to(torch.bfloat16), rows.abs().sum(dim=1)


def check_ell_gather(lists):
    """#4 against its plain version bitwise.  #5 bitwise equal from run to
    run and to its contract (f32 sums in slot order, rounded once), and
    against its plain version (an f32 sum in torch's own order, rounded
    once) within one bf16 ulp of the output plus the f32 reordering bound
    K 2^-24 sum|g|: where a sum cancels, the two orders' f32 results may
    round to bf16 values more than one ulp of the small output apart.  At
    the DHFR, STMV skin and GN-aspirin training shapes (F = 128), at F = 384
    and 1152 (ET's 3H, TensorNet's 9H), at a width whose last span of #5 is
    ragged (#4 copies one bf16 at a time there) and at an odd width (one
    bf16 at a time for both).
    Returns the max abs errors (#4, #5 against the plain version)."""
    import torch

    from torchmdnet_tpu_torch.ops import neighbors as nb
    from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg

    g = torch.Generator().manual_seed(SEED)
    parts, errs = [], [0.0, 0.0]
    for label, f in (("DHFR", 128), ("STMV skin", 128), ("training", 128), ("DHFR", 384), ("DHFR", 1152),
                     ("DHFR", GN_PAIR_F), ("DHFR", GN_ODD_F)):
        nbl = lists[label]
        n, k = nbl.idx.shape
        perm = nbl.transpose_perm
        x = torch.randn(n, f, generator=g).to("cuda", torch.bfloat16)
        ct = torch.randn(n, k, f, generator=g).to("cuda", torch.bfloat16)
        got, want = eg.gather_rows(x, nbl.idx), nb._gather_rows(x, nbl.idx)
        t1, t2 = eg.transpose_sum_rows(ct, nbl.idx, perm), eg.transpose_sum_rows(ct, nbl.idx, perm)
        t_plain = nb._transpose_sum(ct, nbl.idx, perm)
        ordered, abs_sum = _slot_order_sum(ct, perm, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"#4 disagrees with its plain version at {label} F={f}")
        if not (torch.equal(t1, t2) and torch.equal(t1, ordered)):
            raise AssertionError(f"#5 at {label} F={f}: repeat bitwise equal {torch.equal(t1, t2)}, "
                                 f"equal to the slot-order f32 sum {torch.equal(t1, ordered)}")
        d = (t1.float() - t_plain.float()).abs()
        out_ulp = torch.maximum(_bf16_ulp(t1), _bf16_ulp(t_plain))
        if bool((d > out_ulp + k * 2.0**-24 * abs_sum).any()):
            raise AssertionError(f"#5 at {label} F={f}: beyond one bf16 ulp plus the f32 reordering bound "
                                 f"of its plain version")
        beyond = int((d > out_ulp).sum())
        errs[1] = max(errs[1], float(d.max()))
        parts.append(f"{label} N={n} K={k} F={f}: #4 equal, #5 equal to the slot-order sum and from run to "
                     f"run, {float((d / out_ulp).max()):.0f} output ulps from plain at most ({beyond} of "
                     f"{d.numel()} beyond one, within the reordering bound)")
        del x, ct, got, want, t1, t2, t_plain, ordered, abs_sum
    log("ell_gather check (#4 bitwise equal to its plain version; #5 bitwise equal to its contract and "
        "from run to run, within one bf16 ulp plus the f32 reordering bound of its plain version): "
        + "; ".join(parts))
    return tuple(errs)


def log_ell_resources(lists):
    """#4's and #5's resources at each shape a GN path runs them (F = 128)
    and at F = 384 and 1152 at DHFR: the kernel each launch plan takes, its
    registers and spills from the compiled code, blocks an SM from the
    occupancy calculator, and the grid.  Both keep their rows in flight in
    registers: a spill, or shared memory past an H100's 227 KB a block, is
    an error."""
    from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg

    parts = []
    for label, f in (("DHFR", 128), ("STMV skin", 128), ("STMV forward", 128), ("training", 128), ("DHFR", 384),
                     ("DHFR", 1152)):
        n, k = lists[label].idx.shape
        for kind, name in (("gather", "gather_rows_kernel"), ("transpose", "transpose_sum_rows_kernel")):
            if kind == "transpose" and label == "STMV forward":
                continue
            r = eg.kernel_resources(kind, n, k, f)
            if r["spill_bytes"] or r["smem"] > 227 * 1024:
                raise AssertionError(f"{name} at {label} F={f} spills or outgrows shared memory: {r}")
            parts.append(f"{name} at {label} N={n} K={k} F={f}: {r['registers']} registers, {r['spill_bytes']} B "
                         f"spilled, {r['threads']} threads, {r['smem']} B shared, {r['blocks_per_sm']} blocks/SM "
                         f"({r['blocks_per_sm'] * r['threads'] // 32} warps), grid {r['grid']}")
    log("ell_gather kernel resources: " + "; ".join(parts))


def _ell_bounds(n, k, f, kind):
    """Least time: max(bytes / HBM rate, operations / f32 peak).  #4 reads
    the source rows and idx once and writes (N, K, F); #5 reads (N, K, F) and
    perm once, writes (N, F) and adds N*K*F times in f32."""
    if kind == "gather":
        nbytes, ops = 2 * n * f + 4 * n * k + 2 * n * k * f, 0
    else:
        nbytes, ops = 2 * n * k * f + 4 * n * k + 2 * n * f, n * k * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_CUDA_CORE_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")








def time_ell_gather(lists):
    """#4 and #5 (F = 128) on each of ``_gn_lists`` (``ell_cases``): the
    DHFR serving shapes, the STMV skin shapes, the STMV forward's and
    GN-aspirin training's.  For the kernel and its library call, three
    times: the CUDA-event window (L2 flushed, median of 20: ``ms``,
    ``library_ms``), the device time alone (torch.profiler, mean of 20, L2
    flushed: ``device_ms``, ``library_device_ms``) and the host's enqueue
    (host clock without a synchronise, median of 200: ``enqueue_ms``,
    ``library_enqueue_ms``); the plain version's event window and the
    bound."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    out = {}
    for where, (n, k, f), calls in ell_cases(lists):
        out[where] = dict(shape=(n, k, f))
        for kind, (kern, plain, lib) in calls.items():
            bound, by = _ell_bounds(n, k, f, kind)
            out[where][kind] = dict(
                ms=event_ms(kern, flush=flush), plain_ms=event_ms(plain, flush=flush),
                library_ms=event_ms(lib, flush=flush), bound_ms=bound, bound_by=by,
                device_ms=device_ms(kern, flush), library_device_ms=device_ms(lib, flush),
                enqueue_ms=enqueue_ms(kern), library_enqueue_ms=enqueue_ms(lib))
    log("ell_gather kernel times (events: L2 flushed, median of 20; device: torch.profiler, mean of 20; "
        "enqueue: host clock without a synchronise, median of 200): " + "; ".join(
            f"{kind} at {where} N={v['shape'][0]} K={v['shape'][1]} F={v['shape'][2]} {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}, enqueue {t['enqueue_ms']:.4f}; plain {t['plain_ms']:.4f} ms; "
            f"library {t['library_ms']:.4f} ms, device {t['library_device_ms']:.4f}, enqueue "
            f"{t['library_enqueue_ms']:.4f}; bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it reached)"
            for where, v in out.items() for kind, t in v.items() if kind != "shape"))
    return out


def gn_forward():
    """bench.py's headline GN forward: Potential.energy with the list built
    inside the timed call (K = 32, truncated), f32 at DHFR and bf16 messages
    at STMV; the STMV forward gathers through #4 once per layer and
    transposes nothing.  Returns (DHFR ms, STMV ms, STMV launches)."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    out = {}
    for label, args, batch in (("DHFR", GN_FWD_ARGS, _synthetic_batch(DHFR_ATOMS, SEED, "cuda")[2]),
                               ("STMV", GN_STMV_FWD_ARGS, _stmv_batch())):
        model = create_model(args, seed=SEED)
        sizes = probe_cell_kwargs(batch, cutoff_upper=args["cutoff_upper"])
        nbl = model.neighbors(batch, **sizes)
        if bool(nbl.cell_overflow):
            raise AssertionError(f"the GN {label} forward's cell list overflowed {sizes}")
        truncated = bool(nbl.overflow())

        def call():
            with torch.no_grad():
                return model.energy(batch, nbl=model.neighbors(batch, **sizes))

        _reset_launches()
        y = call()
        torch.cuda.synchronize()
        launches = _gn_launches()
        if y.shape != (1, 1) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"GN {label} forward: energy {y}")
        layers = args["num_layers"]
        expected = (layers, 0) if args["bf16_messages"] else (0, 0)
        if launches[:2] != expected:
            raise AssertionError(f"GN {label} forward: expected (#4, #5) launches {expected}, got {launches[:2]}")
        ms = host_ms(call, reps=GN_FWD_REPS)
        out[label] = (ms, launches)
        log(f"GN forward at {label} (bench.py's configuration: 6x128, K={args['max_num_neighbors']}, "
            f"{'bf16 messages' if args['bf16_messages'] else 'f32'}, list built in the call, N={batch.num_atoms}): "
            f"{ms:.3f} ms/call (host clock with sync, median of {GN_FWD_REPS}); list truncated {truncated} "
            f"(true max {int(nbl.n_neighbors.max())} neighbors); launches (#4, #5, select_topk) {launches}; "
            f"energy {float(y[0, 0]):.4f}; the reference's {REF_GN_FWD_MS[label]} ms was measured on a desktop "
            f"NVIDIA GPU, another card")
        del model, nbl
    return out


def _gn_launches():
    """(#4, #5, select_topk) launches."""
    gather, transpose, _, topk = _launches(_gn_km())
    return gather, transpose, topk


def gn_md_stmv():
    """GN molecular dynamics at STMV size through md.Simulation at a rebuild
    cadence at which the skin holds: launches per force evaluation and
    rebuild, stale False, the refined skin list equal to a fresh one, the
    time per step and the peak memory."""
    import torch

    from torchmdnet_tpu_torch import Simulation, create_model

    batch = _stmv_batch()
    real = batch.atom_mask
    torch.cuda.reset_peak_memory_stats()
    model = create_model(GN_ARGS, seed=SEED, std=GN_MD_STD)
    every = GN_MD_EVERY
    sim = Simulation(model, batch, seed=SEED, **dict(MD_ARGS, rebuild_every=every))
    sim.set_velocities_from_temperature(300.0)
    _reset_launches()
    starts = []
    for _ in range(GN_MD_WARMUP_STEPS // every):
        starts.append(sim.state.pos)
        sim.step(every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GN_MD_TIMED_STEPS // every):
        starts.append(sim.state.pos)
        sim.step(every)
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / GN_MD_TIMED_STEPS
    launches = _gn_launches()
    steps = GN_MD_WARMUP_STEPS + GN_MD_TIMED_STEPS
    evaluations, rebuilds, layers = steps + 1, steps // every, GN_ARGS["num_layers"]
    if launches != (layers * evaluations, layers * evaluations, rebuilds):
        raise AssertionError(f"expected {layers}+{layers} (#4, #5) launches per force evaluation ({evaluations}) "
                             f"and one select_topk per rebuild ({rebuilds}), got {launches}")
    state = sim.state
    if not (torch.isfinite(state.pos).all() and torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite positions or energies in GN MD")
    ends = starts[1:] + [state.pos]
    move = max(float((b - a).norm(dim=-1)[real].max()) for a, b in zip(starts, ends))
    if bool(state.stale):
        raise AssertionError(f"the GN skin list went stale at rebuild_every={every} (largest move {move:.3f} A)")
    missed, extra, total = _pairs_against_fresh(sim, model, batch, starts[-1])
    if (missed, extra) != (0, 0):
        raise AssertionError(f"the refined GN skin list and a fresh list differ: {missed} missed, {extra} extra")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"GN MD at STMV size (6x128 bf16 messages, K=80, skin list K={sim._build_nbl(state.pos).k}, "
        f"{int(real.sum())} atoms padded to {batch.num_atoms}, rebuild every {every}, std {GN_MD_STD}, no remat): "
        f"{steps} steps, "
        f"energy {float(state.energy.sum()):.4f} eV; launches (#4, #5, select_topk) {launches} ({evaluations} "
        f"force evaluations, {rebuilds} rebuilds); {ms_step:.3f} ms/step (host clock with sync, mean of "
        f"{GN_MD_TIMED_STEPS}); largest move between rebuilds {move:.3f} A against skin/2 = "
        f"{0.5 * MD_ARGS['neighbor_skin']} A: stale False; the refined skin list holds exactly a fresh list's {total} pairs; "
        f"peak memory {peak_gb:.2f} GiB")
    return launches, sim, ms_step, peak_gb


def tn_strong_messages():
    """TensorNet at weights where the message phase carries a real share of
    the output: each interaction's last edge-MLP layer (linears_scalar.2) and
    its three tensor linears after the message (linears_tensor.3-5) are
    scaled by s, the smallest s of a ladder at which zeroing the messages
    moves the composable fp32 energy by at least 10 %; there the fused bf16
    path against composable fp32 at the end-to-end tolerances."""
    import torch

    from torchmdnet_tpu_torch import External, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS

    z, pos, _ = _synthetic_batch(DHFR_ATOMS, SEED, "cpu")
    fused = create_model(TN_ARGS, seed=SEED)
    ref = create_model(dict(TN_ARGS, bf16_messages=False, fused_message=False), seed=SEED)
    base = {k: v.clone() for k, v in fused.module.state_dict().items()}

    def scaled(s, messages=True):
        sd = dict(base)
        for i in range(TN_ARGS["num_layers"]):
            p = f"representation_model.layers.{i}."
            for name in ("linears_scalar.2.weight", "linears_scalar.2.bias"):
                sd[p + name] = base[p + name] * (s if messages else 0.0)
            for j in (3, 4, 5):
                sd[p + f"linears_tensor.{j}.weight"] = base[p + f"linears_tensor.{j}.weight"] * s
        return sd

    def calc(model, sd):
        model.module.load_state_dict(sd)
        return External((model, None), z[None]).calculate(pos)

    for s in (8, 10, 12, 14, 16, 20, 24, 32):
        e32, f32 = calc(ref, scaled(s))
        e0, f0 = calc(ref, scaled(s, messages=False))
        share = float((e0 - e32).abs().max() / e32.abs().max())
        if share >= 0.1:
            break
    else:
        raise AssertionError(f"no scale of the ladder gives the TensorNet messages 10 % of the energy ({share})")
    f_share = float((f0 - f32).abs().max() / f32.abs().max())
    e, f = calc(fused, scaled(s))
    e_err = float((e - e32).abs().max() / e32.abs().max())
    f_err = float((f - f32).abs().max() / f32.abs().max())
    log(f"TensorNet 2x128 at DHFR with the message MLP's last layer and the tensor linears after it scaled "
        f"by {s}: the message phase carries |dE|/|E| {share:.3e} and max|dF|/max|F| {f_share:.3e} of the "
        f"composable fp32 output (messages zeroed); fused bf16 vs composable fp32 there: |dE|/|E| {e_err:.3e} "
        f"(tol {E2E_ENERGY_TOL}), max|dF|/max|F| {f_err:.3e} (tol {E2E_FORCE_TOL})")
    if e_err > E2E_ENERGY_TOL or f_err > E2E_FORCE_TOL:
        raise AssertionError("fused TensorNet disagrees with composable fp32 where the messages carry the output")


# --- The Transformer (kernels #11-#13) and the fused brute search (#7) ------

T_KERNELS = ("t_fwd_kernel", "t_bwd_kernel", "t_bwd_src_kernel", "t_bwd2_kernel", "t_bwd2_src_kernel",
             "et_dw_kernel")
T_SERVE_KERNELS = ("t_fwd_kernel", "t_bwd_kernel", "t_bwd_src_kernel")
# Transformer MD at DHFR size on the brute-pallas search: a rebuild every
# MD_VALID_EVERY steps, T_MD_STEPS steps.  The random weights' forces moved
# atoms 0.540 A in 2 fs on an H100 at std 1, past skin/2 = 0.25 A, so the
# model's output is standardized by T_MD_STD, as GN MD's is
T_MD_STEPS = 10
T_MD_STD = 0.1






def check_t_parts(nbl, ins, ct, heads, seed):
    """The Transformer's source passes (t_bwd_src_kernel, t_bwd2_src_kernel)
    and its weight reductions (et_dw_kernel at F = 2H) against their plain
    versions, fed the receiver kernels' outputs: {name: max rel err}.  And
    #12's dk/dv against the buffer form the source pass replaces, bitwise:
    the per-edge values (the source kernel on a one-slot view, each edge its
    own atom with its receiver's q and ct: the kernels' filters, which the
    plain twin's exp differs from in a bf16 rounding now and then) summed in
    f32 in slot order through perm and rounded once; {"bwd_src_buffer_differ":
    the elements that differ}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    kw = dict(heads=heads, act="silu", attn_act="silu")
    idx, perm = nbl.idx, nbl.transpose_perm
    n, kk = idx.shape
    e, rbf = n * kk, ins["ea"].shape[-1]
    a = [ins[x] for x in T_ORDER]
    w = a[5:]
    has_w = ins["wdk"] is not None or ins["wdv"] is not None
    _, _, _, hs, dpre, _ = tmk.bwd_receiver(idx, *a, ct, want_dpre=True, **kw)
    got = tmk.bwd_source(idx, perm, *a, ct, hs, **kw)
    want = tmk.bwd_source_reference(idx, perm, ins["q"], ins["ea"], *w, ct, hs, heads=heads, act="silu")
    rel = {"bwd_src": max(_rel(x, y) for x, y in zip(got, want))}
    rows = torch.arange(n, device=idx.device).repeat_interleave(kk)
    one = lambda t: t.index_select(0, rows)  # each edge's receiver row
    edge = tmk.bwd_source(torch.zeros((e, 1), dtype=torch.int32, device=idx.device),
                          torch.arange(e, dtype=torch.int32, device=idx.device), one(ins["q"]), one(ins["k"]),
                          one(ins["v"]), ins["ea"].reshape(e, 1, rbf), ins["cutm"].reshape(e, 1), *w, one(ct),
                          hs, **kw)
    buffer = [_slot_order_sum(t, perm, kk)[0] for t in edge]
    rel["bwd_src_buffer_differ"] = sum(int((g != b).sum()) for g, b in zip(got, buffer))
    if has_w:
        pairs = [(ins["ea"].reshape(e, rbf), dpre)]
        rel["bwd_dw"] = _rel(em.weight_grads(pairs, rbf), em.weight_grads_reference(pairs, rbf))
    z = _t_z_like(ins, seed)
    _, _, _, _, hs4, bpre, bpret, _ = tmk.bwd2_receiver(idx, a, ct, z, **kw)
    got = tmk.bwd2_source(idx, perm, a, ct, z, hs4, **kw)
    want = tmk.bwd2_source_reference(idx, perm, a, ct, z, hs4, heads=heads, act="silu")
    rel["bwd2_src"] = max(_rel(x, y) for x, y in zip(got, want))
    if has_w:
        pairs = [(ins["ea"].reshape(e, rbf), bpre), (z[3].reshape(e, rbf), bpret)]
        rel["bwd2_dw"] = _rel(em.weight_grads(pairs, rbf), em.weight_grads_reference(pairs, rbf))
    torch.cuda.synchronize()
    return rel


def check_t_kernels(label, n_atoms, k, h, heads, rbf, cutoff, seed, batch=None, influence="both"):
    """#11, #12 and #13 against their plain versions: the forward output, the
    nine input cotangents through autograd (the weight cotangents from the
    weight reduction), the second order's nine + 1 gradients, and the
    helper kernels (``check_t_parts``).  Returns the max abs errors (fwd,
    bwd, bwd2)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    nbl, ins, ct = _t_kernel_inputs(n_atoms, k, h, rbf, cutoff, seed, batch=batch, influence=influence)
    idx, perm = nbl.idx, nbl.transpose_perm
    names = [n for n in T_ORDER if ins[n] is not None]
    outs, grads = {}, {}
    for name, fn in (("kernel", tmk.fused_t_messages), ("plain", tmk.t_messages_reference)):
        t = {n: None if v is None else v.clone().requires_grad_(True) for n, v in ins.items()}
        out = fn(idx, *[t[n] for n in T_ORDER], heads=heads, perm=perm)
        g = torch.autograd.grad((out * ct).sum(), [t[n] for n in names], allow_unused=True)
        torch.cuda.synchronize()
        outs[name] = out.detach()
        grads[name] = {n: torch.zeros_like(ins[n]) if gi is None else gi for n, gi in zip(names, g)}
    z = _t_z_like(ins, seed)
    inputs = [ins[n] for n in T_ORDER]
    got = tmk.run_bwd2(idx, perm, inputs, ct, z, heads=heads, act="silu", attn_act="silu")
    want = tmk.t_messages_bwd2_reference(idx, perm, inputs, ct, z, heads=heads)
    torch.cuda.synchronize()
    pairs = [(n, a, b) for n, a, b in zip(T_ORDER, got[0], want[0]) if a is not None] + [("ct", got[1], want[1])]
    bwd2 = {n: _rel(a, b) for n, a, b in pairs}
    bwd2_abs = max(float((a.float() - b.float()).abs().max()) for _, a, b in pairs)
    parts = check_t_parts(nbl, ins, ct, heads, seed)
    fwd = _rel(outs["kernel"], outs["plain"])
    bwd = {n: _rel(grads["kernel"][n], grads["plain"][n]) for n in names}
    fwd_abs = float((outs["kernel"] - outs["plain"]).abs().max())
    bwd_abs = max(float((grads["kernel"][n].float() - grads["plain"][n].float()).abs().max()) for n in names)
    n, kk = idx.shape
    log(f"Transformer kernel check {label} (N={n} K={kk} H={h} heads={heads} RBF={rbf}, influence "
        f"{influence}): fwd max rel err {fwd:.3e} (tol {FWD_TOL}); bwd max rel err {max(bwd.values()):.3e} "
        f"(tol {BWD_TOL}) {_fmt(bwd)}; bwd2 max rel err {max(bwd2.values()):.3e} (tol {BWD2_TOL}) "
        f"{_fmt(bwd2)}; helper kernels against their plain versions "
        f"{_fmt({x: v for x, v in parts.items() if x != 'bwd_src_buffer_differ'})} (source passes tol {PART_TOL}, "
        f"weight reductions tol {WGRAD_TOL}); #12's dk/dv against the buffer form (per-edge values summed in slot "
        f"order): {parts['bwd_src_buffer_differ']} of {2 * idx.shape[0] * h} elements differ")
    if fwd > FWD_TOL:
        raise AssertionError(f"Transformer forward kernel disagrees with the plain version at {label}: {fwd}")
    if max(bwd.values()) > BWD_TOL:
        raise AssertionError(f"Transformer backward kernel disagrees with the plain version at {label}: {bwd}")
    if max(bwd2.values()) > BWD2_TOL:
        raise AssertionError(f"Transformer second-order kernel disagrees with the plain version at {label}: {bwd2}")
    if max(v for x, v in parts.items() if "src" in x and "differ" not in x) > PART_TOL or \
            max([v for x, v in parts.items() if "dw" in x] or [0.0]) > WGRAD_TOL:
        raise AssertionError(f"a Transformer helper kernel disagrees with its plain version at {label}: {parts}")
    if parts["bwd_src_buffer_differ"]:
        raise AssertionError(f"#12's source pass differs from the buffer form at {label}: {parts}")
    return fwd_abs, bwd_abs, bwd2_abs


def _t_bounds(n, kk, h, rbf, kind):
    """Least time for a Transformer edge-phase kernel's work: max(bytes / HBM
    rate, filter products / bf16 tensor peak + the rest / f32 peak), as
    ``_bounds`` counts ET's.

    ``kind``: "fwd", "bwd" (frozen weights), "bwd_w" (with weight
    cotangents) or "bwd2".  The filter products are 2 * RBF * 2H flops per
    edge each: one forward, two backward (recompute, d ea), three with weight
    cotangents, seven second order.  The elementwise work, counted from the
    kernels' arithmetic: ~20 H flops per edge forward (two filter biases and
    activations, four products, the head sum, the attention activation and
    the sum), ~63 H backward, ~70 H second order (the dual forward with the
    activations' first and second derivatives, its reverse, three head sums
    and a channel sum).
    """
    e = n * kk
    f = 2 * h
    filt = 2 * (rbf * f + f)  # filters (bf16)
    in_bytes = 4 * e + 2 * 3 * n * h + 2 * e * rbf + 4 * e + filt  # idx, q/k/v, ea, cutm, filters
    mm_one = 2 * e * rbf * f
    if kind == "fwd":
        nbytes, mm, ew = in_bytes + 4 * n * h, mm_one, 20 * h * e
    elif kind in ("bwd", "bwd_w"):
        nbytes = in_bytes + 4 * n * h + 4 * e + 2 * 3 * n * h + 2 * e * rbf + 4 * e  # ct, perm, dq/dk/dv, dea, dcutm
        mm, ew = 2 * mm_one, 63 * h * e
        if kind == "bwd_w":
            nbytes += filt
            mm += mm_one
    else:
        nbytes = (in_bytes + 4 * n * h + 4 * e  # ct, perm
                  + 2 * 3 * n * h + 2 * e * rbf + 4 * e + filt  # Z on the backward's outputs
                  + 2 * 3 * n * h + 2 * e * rbf + 4 * e + filt  # g_inputs
                  + 4 * n * h)  # g_ct
        mm, ew = 7 * mm_one, 70 * h * e
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mm / BF16_TENSOR_FLOPS + ew / F32_CUDA_CORE_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_t_kernels(train_batch):
    """#11 and #12 (with and without weight cotangents) at the DHFR serving
    shapes, #11, #12 with weight cotangents and #13 at the training shapes:
    each kernel's time (L2 flushed, median of 20), its plain version's and
    its bound.  No single PyTorch call computes the fused phase."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    kw = dict(act="silu", attn_act="silu")
    out = {}
    for where, a, n_atoms, batch, kinds in (
        ("DHFR", T_ARGS, 2489, None, ("fwd", "bwd", "bwd_w")),
        ("training", T_TRAIN_ARGS, None, train_batch, ("fwd", "bwd_w", "bwd2")),
    ):
        h, heads, rbf = a["embedding_dimension"], a["num_heads"], a["num_rbf"]
        nbl, ins, ct = _t_kernel_inputs(n_atoms, a["max_num_neighbors"], h, rbf, a["cutoff_upper"], SEED,
                                        batch=batch)
        idx, perm = nbl.idx, nbl.transpose_perm
        n, kk = idx.shape
        args = [ins[x] for x in T_ORDER]
        z = _t_z_like(ins, SEED)
        for k in kinds:
            if k == "fwd":
                ms = event_ms(lambda: tmk.run_fwd(idx, *args, heads=heads, **kw), flush=flush)
                plain = event_ms(lambda: tmk.t_messages_reference(idx, *args, heads=heads, perm=perm), flush=flush)
            elif k in ("bwd", "bwd_w"):
                want = k == "bwd_w"
                ms = event_ms(lambda: tmk.run_bwd(idx, perm, *args, ct, heads=heads, want_weight_grads=want, **kw),
                               flush=flush)
                t = {x: v.clone().requires_grad_(want or x not in ("wdk", "bdk", "wdv", "bdv")) for x, v in ins.items()}
                m = tmk.t_messages_reference(idx, *[t[x] for x in T_ORDER], heads=heads, perm=perm)
                leaves = [t[x] for x in T_ORDER if t[x].requires_grad]
                plain = event_ms(lambda: torch.autograd.grad(m, leaves, ct, retain_graph=True), flush=flush)
                del m, t
            else:
                ms = event_ms(lambda: tmk.run_bwd2(idx, perm, args, ct, z, heads=heads, **kw), flush=flush)
                plain = event_ms(lambda: tmk.t_messages_bwd2_reference(idx, perm, args, ct, z, heads=heads),
                                  flush=flush, reps=5)
            out[(where, k)] = (ms, plain) + _t_bounds(n, kk, h, rbf, k) + ((n, kk, h),)
        split = _t_pass_split(idx, perm, args, ct, z, heads, flush)
        log(f"Transformer passes at {where} (N={n} K={kk} H={h}; L2 flushed, median of 20): "
            + "; ".join(f"{name} {ms:.4f} ms" for name, ms in split.items()))
    log("Transformer kernel times (L2 flushed, median of 20; plain second order of 5): " + "; ".join(
        f"{k} at {where} (N={v[4][0]} K={v[4][1]} H={v[4][2]}) {v[0]:.4f} ms (plain {v[1]:.4f} ms, bound "
        f"{v[2]:.4f} ms by {v[3]}, {100 * v[2] / v[0]:.1f}% of it reached)" for (where, k), v in out.items()))
    return out


def _t_pass_split(idx, perm, args, ct, z, heads, flush):
    """#12 (with weight cotangents) and #13 pass by pass: each pass's time
    alone (L2 flushed, median of 20), fed the receiver passes' outputs."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    kw = dict(heads=heads, act="silu", attn_act="silu")
    n, kk = idx.shape
    ea = args[3].reshape(n * kk, -1)
    rbf = ea.shape[-1]
    _, _, _, hs, dpre, _ = tmk.bwd_receiver(idx, *args, ct, want_dpre=True, **kw)
    _, _, _, _, hs4, bpre, bpret, _ = tmk.bwd2_receiver(idx, args, ct, z, **kw)
    zea = z[3].reshape(n * kk, -1)
    calls = {
        "t_bwd_kernel": lambda: tmk.bwd_receiver(idx, *args, ct, want_dpre=True, **kw),
        "t_bwd_src_kernel": lambda: tmk.bwd_source(idx, perm, *args, ct, hs, **kw),
        "et_dw_kernel (#12)": lambda: em.weight_grads([(ea, dpre)], rbf),
        "t_bwd2_kernel": lambda: tmk.bwd2_receiver(idx, args, ct, z, **kw),
        "t_bwd2_src_kernel": lambda: tmk.bwd2_source(idx, perm, args, ct, z, hs4, **kw),
        "et_dw_kernel (#13)": lambda: em.weight_grads([(ea, bpre), (zea, bpret)], rbf),
    }
    return {name: event_ms(fn, flush=flush) for name, fn in calls.items()}


def _zero_t_messages(rep):
    """Every attention layer's messages zeroed: v = 0 makes each edge's
    message v_j * dv * attn zero."""
    for layer in rep.attention_layers:
        layer.v_proj.weight.zero_()
        layer.v_proj.bias.zero_()


def t_strong_messages(share):
    """Where the Transformer's edge phase carries under 10 % of the energy at
    chip_smoke's weights, the same check at weights where it carries more:
    each layer's output projection (o_proj, which takes the messages) scaled
    by the smallest s of a ladder at which zeroing the messages moves the
    composable fp32 energy by at least 10 %; there the fused bf16 path
    against composable fp32 at the end-to-end tolerances."""
    import torch

    from torchmdnet_tpu_torch import External, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS

    if share >= 0.1:
        log(f"Transformer: the edge phase carries {share:.3e} of the composable fp32 energy at chip_smoke's "
            f"weights (>= 10 %): no check at scaled weights needed")
        return
    z, pos, _ = _synthetic_batch(DHFR_ATOMS, SEED, "cpu")
    fused = create_model(T_ARGS, seed=SEED)
    ref = create_model(dict(T_ARGS, bf16_messages=False, fused_attention=False), seed=SEED)
    base = {k: v.clone() for k, v in fused.module.state_dict().items()}

    def scaled(s, messages=True):
        sd = dict(base)
        for i in range(T_ARGS["num_layers"]):
            p = f"representation_model.attention_layers.{i}."
            sd[p + "o_proj.weight"] = base[p + "o_proj.weight"] * s
            for name in ("v_proj.weight", "v_proj.bias"):
                sd[p + name] = base[p + name] * (1.0 if messages else 0.0)
        return sd

    def calc(model, sd):
        model.module.load_state_dict(sd)
        return External((model, None), z[None]).calculate(pos)

    for s in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64):
        e32, f32 = calc(ref, scaled(s))
        e0, f0 = calc(ref, scaled(s, messages=False))
        share = float((e0 - e32).abs().max() / e32.abs().max())
        if share >= 0.1:
            break
    else:
        raise AssertionError(f"no scale of the ladder gives the Transformer's messages 10 % of the energy ({share})")
    f_share = float((f0 - f32).abs().max() / f32.abs().max())
    e, f = calc(fused, scaled(s))
    e_err = float((e - e32).abs().max() / e32.abs().max())
    f_err = float((f - f32).abs().max() / f32.abs().max())
    log(f"Transformer 6x128 at DHFR with o_proj scaled by {s}: the edge phase carries |dE|/|E| {share:.3e} and "
        f"max|dF|/max|F| {f_share:.3e} of the composable fp32 output (messages zeroed); fused bf16 vs composable "
        f"fp32 there: |dE|/|E| {e_err:.3e} (tol {E2E_ENERGY_TOL}), max|dF|/max|F| {f_err:.3e} (tol {E2E_FORCE_TOL})")
    if e_err > E2E_ENERGY_TOL or f_err > E2E_FORCE_TOL:
        raise AssertionError("the fused Transformer disagrees with composable fp32 where the messages carry the output")


def _brute_pairs(nbl, n):
    import torch

    rows = torch.arange(n, device=nbl.idx.device)[:, None].expand_as(nbl.idx)
    return (rows * n + nbl.idx.long())[nbl.mask]


# #7's multi-stage checks: more columns than one shared-memory stage holds
# (4096), in several molecules that overlap in space, with atoms masked
# inside them besides the padding, and a K that truncates most rows (about
# 50 neighbors within 5 A at DHFR's density); the plain version's (N, N)
# matrices fit.  {label: (atoms, molecules, atoms a molecule)}: 16,000
# atoms (4 rows a warp; stages of 4096 columns and a last of 3712) and
# 5000 (2 rows a warp; a last stage of 904 columns, not a multiple of 32,
# so padding entries go through the sweep)
COMPACTION_STAGE_CASES = {"multi-stage": (16000, 4, 3990), "ragged multi-stage": (5000, 3, 1650)}
COMPACTION_STAGE_K = 48
COMPACTION_MASK_EVERY = 101


def _compaction_stage_batch(atoms, molecules, molecule_atoms):
    """(batch, atom_mask): ``molecules`` synthetic molecules at DHFR's
    density, padded to ``atoms``, and the batch's mask with every
    COMPACTION_MASK_EVERY-th atom cleared."""
    from torchmdnet_tpu_torch.data.batch import pad_molecules
    from torchmdnet_tpu_torch.data.systems import synthetic_system

    mols = [dict(zip(("z", "pos"), synthetic_system(molecule_atoms, seed=SEED + m))) for m in range(molecules)]
    batch = pad_molecules(mols, num_atoms=atoms, device="cuda")
    mask = batch.atom_mask.clone()
    mask[::COMPACTION_MASK_EVERY] = False
    return batch, mask


def log_compaction_resources():
    """#7's launch plan and resources at each N it is checked or runs at
    (DHFR and the MD build, the training batch, the multi-stage checks):
    rows a warp, threads, blocks, registers, spills, shared memory, blocks
    an SM.  A spill, or shared memory past an H100's 227 KB a block, is an
    error."""
    from torchmdnet_tpu_torch.ops.kernels import compaction

    parts = []
    sizes = [("DHFR", 2496), ("training", 2304)] + [(lab, c[0]) for lab, c in COMPACTION_STAGE_CASES.items()]
    for label, n in sizes:
        r = compaction.kernel_resources(n)
        if r["spill_bytes"] or r["smem"] > 227 * 1024:
            raise AssertionError(f"compact_kernel at {label} N={n} spills or outgrows shared memory: {r}")
        parts.append(f"{label} N={n}: {r['rows']} rows a warp, {r['threads']} threads, grid {r['grid']}, "
                     f"{r['registers']} registers, {r['spill_bytes']} B spilled, {r['smem']} B shared "
                     f"({r['stage']} columns a stage), {r['blocks_per_sm']} blocks/SM")
    log("compact_kernel resources: " + "; ".join(parts))


def check_compaction(label, batch, k, cutoff_upper, cutoff_lower=0.0, model=None, skin=0.0, atom_mask=None,
                     ids=None):
    """#7 on its entry points against its plain version, bitwise, with and
    without the self loop: the loop list through ``model.neighbors(strategy=
    "brute-pallas", skin=skin)`` when a model is given (``k`` and the
    cutoffs must be the ones it builds with), else ``neighbor_list``.
    ``atom_mask`` and ``ids`` replace the batch's (atoms masked inside
    molecules; int32 molecule ids).  Logs how many pairs differ from the
    Gram-form ``strategy="brute"`` list.  Returns the max abs error (0 when
    bitwise equal)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels.compaction import compact_neighbors_reference
    from torchmdnet_tpu_torch.ops.neighbors import neighbor_list

    n = batch.num_atoms
    args = (batch.pos, batch.batch if ids is None else ids, batch.atom_mask if atom_mask is None else atom_mask)
    kw = dict(k=k, cutoff_lower=cutoff_lower, cutoff_upper=cutoff_upper)
    for loop in (True, False):
        want_idx, want_mask, want_count = compact_neighbors_reference(*args, loop=loop, **kw)
        if loop and model is not None:
            got = model.neighbors(batch, strategy="brute-pallas", skin=skin)
        else:
            got = neighbor_list(*args, loop=loop, strategy="brute-pallas", **kw)
        torch.cuda.synchronize()
        if not (got.idx.shape == want_idx.shape and torch.equal(got.idx, want_idx)
                and torch.equal(got.mask, want_mask) and torch.equal(got.n_neighbors, want_count)
                and got.self_loops == loop):
            bad = int((got.idx != want_idx).sum()) if got.idx.shape == want_idx.shape else -1
            raise AssertionError(f"#7 differs from its plain version at {label} (loop={loop}): {bad} slots")
        del want_idx, want_mask
    brute = neighbor_list(*args, strategy="brute", **kw)
    fused = neighbor_list(*args, strategy="brute-pallas", **kw)
    pb, pf = _brute_pairs(brute, n), _brute_pairs(fused, n)
    only_brute, only_fused = int((~torch.isin(pb, pf)).sum()), int((~torch.isin(pf, pb)).sum())
    entry = "Potential.neighbors" if model is not None else "neighbor_list"
    log(f"compaction check {label} (N={n} K={k} cutoff {cutoff_lower}-{cutoff_upper} A, {batch.num_mol} molecules, "
        f"{int((~args[2]).sum())} atoms masked, {args[1].dtype} ids): bitwise equal to its plain version with and "
        f"without the self loop ({entry}(strategy='brute-pallas')), true max {int(want_count.max())} neighbors; "
        f"against the Gram-form strategy='brute' list: {only_brute} pairs only there, {only_fused} only here, of "
        f"{int(pb.numel())}")
    del brute, fused, pb, pf
    torch.cuda.empty_cache()
    return 0.0




def _compaction_bounds(n, k, pairs):
    """Least time for #7: max(bytes / HBM rate, pair tests / f32 peak).
    Bytes: positions, ids and mask in, idx, mask and counts out; operations:
    about 9 f32 operations per tested pair (three differences, three
    products, two sums, the comparisons)."""
    nbytes = 12 * n + 4 * n + n + 4 * n * k + n * k + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 9 * pairs / F32_CUDA_CORE_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_compaction(batch):
    """#7 at ``compaction_shapes`` on the synthetic DHFR system: the kernel's
    wrapper and the whole brute-pallas build (``neighbor_list``), each timed
    three ways (``_three_ways``: the CUDA-event window, compact_kernel's
    device time alone, the host's enqueue), the plain version's and the
    strategy='brute' route's event windows (Gram-form distances and
    torch.topk: the library yardstick) and the bound.  A build must launch
    one kernel, #7.  Returns {shape: times}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels.compaction import compact_neighbors, compact_neighbors_reference
    from torchmdnet_tpu_torch.ops.neighbors import neighbor_list

    n = batch.num_atoms
    args = (batch.pos, batch.batch, batch.atom_mask)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    out = {}
    for where, s in compaction_shapes().items():
        kw = dict(k=s["k"], cutoff_lower=s["cutoff_lower"], cutoff_upper=s["cutoff_upper"], loop=s["loop"])
        kern = _three_ways(lambda: compact_neighbors(*args, **kw), flush, "compact_kernel")
        build = _three_ways(lambda: neighbor_list(*args, strategy="brute-pallas", **kw), flush, "compact_kernel")
        if build["launches"] != 1 or build["other_launches"] or build["other_ms"]:
            raise AssertionError(f"a brute-pallas build at {where} ran {build['launches']:g} compact_kernel and "
                                 f"{build['other_launches']:g} other kernels ({build['other_ms']:.4f} ms), not #7 "
                                 f"once")
        bound, by = _compaction_bounds(n, s["k"] + s["loop"], n * n)
        out[where] = dict(
            k=s["k"], loop=s["loop"], cutoff_upper=s["cutoff_upper"],
            ms=kern["ms"], device_ms=kern["device_ms"], enqueue_ms=kern["enqueue_ms"],
            build_ms=build["ms"], build_device_ms=build["device_ms"],
            build_enqueue_ms=build["enqueue_ms"], build_launches=build["launches"],
            plain_ms=event_ms(lambda: compact_neighbors_reference(*args, **kw), flush=flush),
            library_ms=event_ms(lambda: neighbor_list(*args, strategy="brute", **kw), flush=flush),
            bound_ms=bound, bound_by=by)
    log("compaction times (events: L2 flushed, median of 20; device: torch.profiler, mean of 20; enqueue: host "
        "clock without a synchronise, median of 200): " + "; ".join(
            f"{where} N={n} K={t['k']}{' + loop' if t['loop'] else ''} cutoff {t['cutoff_upper']} A: kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, enqueue {t['enqueue_ms']:.4f}); brute-pallas build "
            f"{t['build_ms']:.4f} ms (device {t['build_device_ms']:.4f}, enqueue {t['build_enqueue_ms']:.4f}, "
            f"{t['build_launches']:g} launch); plain {t['plain_ms']:.4f} ms; strategy='brute' route "
            f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it reached"
            for where, t in out.items()))
    return out


def t_md_brute_pallas():
    """Transformer molecular dynamics at DHFR size through md.Simulation on
    the brute-pallas search, at a rebuild cadence at which the skin holds:
    #7 once per build, #11/#12 once per layer per force evaluation, stale
    False, two runs from one seed bitwise equal, the last skin list refined
    at the final positions equal to a fresh brute-pallas list."""
    import torch

    from torchmdnet_tpu_torch import Simulation, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
    from torchmdnet_tpu_torch.ops.kernels.compaction import compact_neighbors
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    batch = _synthetic_batch(DHFR_ATOMS, SEED, "cuda")[2]
    real = batch.atom_mask
    model = create_model(T_ARGS, seed=SEED, std=T_MD_STD)
    every = MD_VALID_EVERY
    runs = []
    for r in range(2):
        sim = Simulation(model, batch, seed=SEED, neighbor_strategy="brute-pallas",
                         **dict(MD_ARGS, rebuild_every=every))
        sim.set_velocities_from_temperature(300.0)
        _reset_launches()
        starts = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(T_MD_STEPS // every):
            starts.append(sim.state.pos)
            sim.step(every)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.perf_counter() - t0) / T_MD_STEPS
        if r == 0:
            launches = (tmk.run_fwd.launches, tmk.run_bwd.launches, compact_neighbors.launches,
                        select_topk.launches)
            _check_t_parts("t_md_brute_pallas", launches[1], 0)
        runs.append((sim, starts, ms_step))
    (sim, starts, ms_step), (other, _, _) = runs
    evaluations, rebuilds, layers = T_MD_STEPS + 1, T_MD_STEPS // every, T_ARGS["num_layers"]
    if launches != (layers * evaluations, layers * evaluations, rebuilds, 0):
        raise AssertionError(f"expected {layers}+{layers} (#11, #12) launches per force evaluation ({evaluations}), "
                             f"one #7 per rebuild ({rebuilds}) and no select_topk, got {launches}")
    state = sim.state
    if not (torch.isfinite(state.pos).all() and torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite positions or energies in Transformer MD")
    if not torch.equal(state.pos, other.state.pos):
        raise AssertionError("two Transformer Simulations from the same batch and seed diverged")
    ends = starts[1:] + [state.pos]
    move = max(float((b - a).norm(dim=-1)[real].max()) for a, b in zip(starts, ends))
    if bool(state.stale):
        raise AssertionError(f"the brute-pallas skin list went stale at rebuild_every={every} (move {move:.3f} A)")
    skin_nbl = sim._build_nbl(starts[-1])
    refined = skin_nbl.refine(state.pos, T_ARGS["cutoff_lower"], T_ARGS["cutoff_upper"])
    fresh = model.neighbors(batch.replace(pos=state.pos), k=skin_nbl.k - 1, strategy="brute-pallas")
    fresh.raise_on_overflow("chip_smoke fresh Transformer MD list")
    n = batch.num_atoms
    r, f = _brute_pairs(refined, n), _brute_pairs(fresh, n)
    missed, extra = int((~torch.isin(f, r)).sum()), int((~torch.isin(r, f)).sum())
    if (missed, extra) != (0, 0):
        raise AssertionError(f"the refined brute-pallas skin list and a fresh one differ: {missed} missed, "
                             f"{extra} extra")
    log(f"Transformer MD at DHFR size on strategy='brute-pallas' (6x128 fused bf16, {int(real.sum())} atoms padded "
        f"to {n}, skin list K={skin_nbl.k}, rebuild every {every}, std {T_MD_STD}): {T_MD_STEPS} steps, energy "
        f"{float(state.energy.sum()):.4f} eV; launches (#11, #12, #7, select_topk) {launches} ({evaluations} force "
        f"evaluations, {rebuilds} rebuilds); {ms_step:.3f} ms/step (host clock with sync, mean of {T_MD_STEPS}); "
        f"largest move between rebuilds {move:.3f} A against skin/2 = {0.5 * MD_ARGS['neighbor_skin']} A: stale "
        f"False; two runs from one seed bitwise equal; the refined skin list holds exactly a fresh list's "
        f"{int(f.numel())} pairs")
    return launches, ms_step


# --- the output heads and the pair priors: ZBL serving, dipole serving, ---
# --- force training with ZBL, D2 and Coulomb -------------------------------

EV = 1.602176634e-19  # J: positions in A and energies in eV, as SyntheticMorse's
# ZBL's capacities tried on DHFR, from the JAX package's default up
ZBL_K_TRIED = (32, 48, 64)
# the prior alone on the card (f32) against an f64 sum of its closed form
# over all pairs: f32 rounding of exp, pow and the pair sums, |dE|/|E| and
# max|dF|/max|F|
ZBL_TOL = 1e-5
# (E, F) with the prior minus (E, F) without it against the prior's own: the
# model part is bitwise the same (same weights, list and kernels), so only
# the f32 rounding of the totals and of autograd's sum of the position
# cotangents is left, a few ulps of the largest term
ZBL_SUM_ULPS = 16
# ET's serving of the dipole moment at examples/ET-QM9.yaml's widths: 8 x 256,
# 8 heads, 64 ExpNormal RBFs (not trainable), 0-5 A, K 64, NeighborEmbedding,
# the fused bf16 edge phase; DipoleMoment becomes EquivariantDipoleMoment
DIPOLE_ARGS = dict(TRAIN_ARGS, max_num_neighbors=64, output_model="DipoleMoment", derivative=False)
# the other heads, each with its tolerance against its composable path: the
# spatial extent is a positive sum like |mu| (FWD_TOL of the largest value);
# the vector output sums per-atom vectors that cancel, like forces
# (E2E_FORCE_TOL of the largest component)
DIPOLE_OTHER_HEADS = {"ElectronicSpatialExtent": FWD_TOL, "EquivariantVectorOutput": E2E_FORCE_TOL}
# force training with the three pair priors, their arguments from the
# dataset (atomic numbers 0-99, A, eV): batches of 64 molecules (1152 atoms),
# below the 2048 atoms from which a prior's own list would take the cell
# route (every SyntheticMorse molecule lies in the same 6 A box, so a cell
# list of 128 molecules overflows its cells, as the JAX package's does)
PRIOR_TRAIN_BATCH = 64
PRIOR_TRAIN_SPLIT = (192, 64, 64)  # three training steps, one validation batch
PRIOR_TRAIN_PRIORS = ["ZBL", "D2", "Coulomb"]


def _zbl_kwargs(k):
    return {"cutoff_distance": ZBL_CUTOFF, "max_num_neighbors": k, "atomic_number": list(range(100)),
            "distance_scale": 1e-10, "energy_scale": EV}


def _dhfr_requests():
    """(z, pos, requests): the DHFR system and main_path's requests."""
    import numpy as np

    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS

    z, pos, _ = _synthetic_batch(DHFR_ATOMS, SEED, "cpu")
    rng = np.random.default_rng(SEED)
    requests = [pos + rng.normal(scale=0.02, size=pos.shape).astype(np.float32) for _ in range(REQUESTS - 1)]
    requests.append(requests[-1].copy())  # the last request repeats the one before
    return z, pos, requests


def find_zbl_k():
    """The smallest of ZBL_K_TRIED at which External's first request (its
    capacity checks) passes for ET with a ZBL prior on DHFR; logs what each
    smaller capacity raised."""
    from torchmdnet_tpu_torch import External, create_model

    z, _, requests = _dhfr_requests()
    raised = []
    for k in ZBL_K_TRIED:
        ext = External((create_model(dict(ET_ARGS, prior_model={"ZBL": _zbl_kwargs(k)}), seed=SEED), None), z[None])
        try:
            ext.calculate(requests[0])
        except ValueError as e:
            if "ZBL prior" not in str(e):
                raise
            raised.append(f"K={k}: {e}")
            continue
        log(f"ZBL prior capacity at DHFR size ({ZBL_CUTOFF} A): External's first request passes at K={k}; "
            + ("; ".join(raised) if raised else "no smaller capacity tried"))
        return k
    raise AssertionError(f"External raised at every ZBL capacity of {ZBL_K_TRIED}: {raised}")


def _zbl_reference(z, pos):
    """ZBL's energy (eV) and forces (eV/A) of one molecule in float64, summed
    over all pairs within the cutoff from the closed form (the screening
    function of Ziegler, Biersack and Littmark under a cosine cutoff), with
    no neighbor list and none of the prior's code."""
    import torch

    bohr, k_e = 5.29177210903e-11, 2.30707755e-28  # m; J m
    p = pos.double().detach().requires_grad_(True)
    zz = z.double()
    i, j = torch.triu_indices(p.shape[0], p.shape[0], 1, device=p.device)
    with torch.no_grad():
        near = (p[i] - p[j]).norm(dim=-1) < ZBL_CUTOFF
    i, j = i[near], j[near]
    r = (p[i] - p[j]).norm(dim=-1)
    a = 0.8854 * bohr / (zz[i] ** 0.23 + zz[j] ** 0.23)
    x = r * 1e-10 / a
    phi = (0.1818 * torch.exp(-3.2 * x) + 0.5099 * torch.exp(-0.9423 * x) + 0.2802 * torch.exp(-0.4029 * x)
           + 0.02817 * torch.exp(-0.2016 * x))
    cut = 0.5 * (torch.cos(math.pi * r / ZBL_CUTOFF) + 1.0)
    energy = (k_e / EV / 1e-10) * (phi * cut * zz[i] * zz[j] / r).sum()
    (grad,) = torch.autograd.grad(energy, p)
    return energy.detach(), -grad, int(near.sum())


def zbl_path(zbl_k):
    """Phase A: ET energy + forces at DHFR size through External with a ZBL
    prior (atomic numbers 0-99, A, eV, K = ``zbl_k``).  Per request the
    forward and backward kernels run once per layer, and #6 twice: the
    model's cell list and the prior's own (External probes the sizes of
    both on the first request).  Checks: the prior's energy and forces on
    the card against ``_zbl_reference``; (E, F) with the prior minus (E, F)
    of the same weights without it equal to the prior's own; two identical
    requests bitwise equal.  Returns ((fwd, bwd, the model's #6 launches),
    the prior's #6 launches, the External, its first request)."""
    import torch

    from torchmdnet_tpu_torch import External, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    z, _, requests = _dhfr_requests()
    potential = create_model(dict(ET_ARGS, prior_model={"ZBL": _zbl_kwargs(zbl_k)}), seed=SEED)
    plain = create_model(ET_ARGS, seed=SEED)
    plain.module.load_state_dict(potential.module.state_dict())
    prior = potential.module.priors[0]
    # count the selection launches of the prior's own builds apart from the model's
    prior_builds = [0]
    build = prior.build_neighbor_list

    def counted_build(*args):
        before = select_topk.launches
        out = build(*args)
        prior_builds[0] += select_topk.launches - before
        return out

    prior.build_neighbor_list = counted_build
    ext = External((potential, None), z[None])
    _reset_launches()
    results = []
    for p in requests:
        energy, forces = ext.calculate(p)
        results.append((energy.clone(), forces.clone()))
    torch.cuda.synchronize()
    prior_launches = prior_builds[0]
    launches = (em.run_fwd.launches, em.run_bwd.launches, select_topk.launches - prior_launches)
    layers = ET_ARGS["num_layers"]
    if launches != (layers * REQUESTS, layers * REQUESTS, REQUESTS + 1) or prior_launches != REQUESTS + 1:
        raise AssertionError(f"expected {layers} fwd + {layers} bwd launches per request and {REQUESTS + 1} "
                             f"select_topk launches each for the model's and the prior's lists, got {launches} "
                             f"and {prior_launches}")
    _check_et_parts("zbl_external_dhfr", launches[1], 0)
    for energy, forces in results:
        if not (torch.isfinite(energy).all() and torch.isfinite(forces).all()):
            raise AssertionError("non-finite energy or forces with the ZBL prior")
    if not (torch.equal(results[-1][0], results[-2][0]) and torch.equal(results[-1][1], results[-2][1])):
        raise AssertionError("two identical requests with the ZBL prior differ")

    # the prior alone, on the card in f32, against the f64 closed form
    batch = ext._template
    pos = torch.cat([torch.as_tensor(requests[0], device="cuda"), batch.pos.new_zeros((ext.n_pad, 3))])
    pos.requires_grad_(True)
    e_prior = prior.post_reduce(torch.zeros((1, 1), device="cuda"), batch.z, pos, batch.batch, batch.atom_mask, 1)
    (grad,) = torch.autograd.grad(e_prior.sum(), pos)
    f_prior = -grad[:DHFR_ATOMS]
    e_ref, f_ref, pairs = _zbl_reference(batch.z[:DHFR_ATOMS], pos[:DHFR_ATOMS])
    e_err = float((e_prior.double().sum() - e_ref).abs() / e_ref.abs())
    f_err = float((f_prior.double() - f_ref).abs().max() / f_ref.abs().max())
    # with the prior minus without it
    e0, f0 = External((plain, None), z[None]).calculate(requests[0])
    e1, f1 = results[0]
    f_prior = f_prior.reshape(f1.shape)
    eps = torch.finfo(torch.float32).eps
    de = float(((e1 - e0) - e_prior.detach().reshape(e1.shape)).abs().max())
    df = float(((f1 - f0) - f_prior).abs().max())
    de_tol = ZBL_SUM_ULPS * eps * float(e0.abs().max() + e_prior.abs().max())
    df_tol = ZBL_SUM_ULPS * eps * float(max(f0.abs().max(), f_prior.abs().max()))
    with_ms = host_ms(lambda: ext.calculate(requests[0]))
    without = External((plain, None), z[None])
    without.calculate(requests[0])
    without_ms = host_ms(lambda: without.calculate(requests[0]))
    log(f"ET {layers}x{ET_ARGS['embedding_dimension']} fused with a ZBL prior (K={zbl_k}, {ZBL_CUTOFF} A) through "
        f"External at DHFR size: {REQUESTS} requests; launches fwd {launches[0]} bwd {launches[1]}, select_topk "
        f"{launches[2]} for the model's lists and {prior_launches} for the prior's (one more a call than "
        f"without the prior); "
        f"repeat bitwise equal: True; the prior on the card (f32) vs the f64 closed form over {pairs} pairs: "
        f"E {float(e_prior.detach().sum()):.6f} eV vs {float(e_ref):.6f}, |dE|/|E| {e_err:.3e}, max|dF|/max|F| {f_err:.3e} "
        f"(tol {ZBL_TOL}); with minus without vs the prior alone: |dE| {de:.3e} (tol {de_tol:.3e}), max|dF| "
        f"{df:.3e} (tol {df_tol:.3e}); per call (host clock with sync, median of 20) {with_ms:.3f} ms with "
        f"the prior, {without_ms:.3f} ms without")
    if e_err > ZBL_TOL or f_err > ZBL_TOL:
        raise AssertionError("the ZBL prior on the card disagrees with its closed form")
    if de > de_tol or df > df_tol:
        raise AssertionError("External with the ZBL prior is not the model without it plus the prior")
    del prior.build_neighbor_list  # the class's method again
    return launches, prior_launches, ext, requests[0]


def _rotate_molecules(batch, seed):
    """``batch`` with every molecule turned by its own random rotation about
    its centroid (seeded), padding atoms left in place."""
    import torch

    g = torch.Generator().manual_seed(seed)
    m = batch.num_mol
    q, r = torch.linalg.qr(torch.randn(m, 3, 3, generator=g, dtype=torch.float64))
    rot = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    rot = (rot * torch.linalg.det(rot)[:, None, None]).to(batch.pos.device)  # proper rotations
    real = batch.atom_mask
    ids, pos = batch.batch[real], batch.pos[real].double()
    count = torch.bincount(ids, minlength=m).clamp(min=1).double()
    centroid = torch.zeros((m, 3), dtype=pos.dtype, device=pos.device).index_add_(0, ids, pos) / count[:, None]
    turned = torch.einsum("nij,nj->ni", rot[ids], pos - centroid[ids]) + centroid[ids]
    out = batch.pos.clone()
    out[real] = turned.to(out.dtype)
    return batch.replace(pos=out)


def dipole_path(ds, tn_batch):
    """Phase B: the dipole moment served by ET at examples/ET-QM9.yaml's
    widths, fused bf16, derivative false, on 128 SyntheticMorse molecules of
    18 atoms: #1 once per layer per call (the batch's list is brute:
    ``Potential.neighbors`` sends batches of small molecules there, so #6
    does not run).  Checks against the composable fp32 path (FWD_TOL of the
    largest |mu|), |mu| under a seeded rotation of every molecule and mu
    under a translation (the same tolerance: the bf16 roundings move with
    the inputs); the spatial extent and the vector heads one call each
    against their composable path, and TensorNet's DipoleMoment on its
    training batch (TN_FWD_TOL).  Returns (#1 launches of the dipole call,
    #8 launches of TensorNet's, #1's (ms, plain ms, bound ms, bound by) at
    this shape, its largest absolute error against its plain version, the
    dipole call)."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    batch = _train_batch(ds, "cuda")
    layers = DIPOLE_ARGS["num_layers"]

    def pair(args, seed=SEED):
        fused = create_model(args, seed=seed)
        comp = create_model(dict(args, bf16_messages=False, fused_attention=False, fused_message=False), seed=seed)
        comp.module.load_state_dict(fused.module.state_dict())
        return fused, comp

    def serve(model, b):
        with torch.no_grad():
            return model.energy(b, nbl=model.neighbors(b).raise_on_overflow("the dipole batch"))

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    fused, comp = pair(DIPOLE_ARGS)
    head = type(fused.module.output_model).__name__
    if head != "EquivariantDipoleMoment" or fused.module.priors:
        raise AssertionError(f"expected an EquivariantDipoleMoment head without priors, got {head}")
    _reset_launches()
    mu = serve(fused, batch)
    torch.cuda.synchronize()
    launches = (em.run_fwd.launches, select_topk.launches)
    if launches != (layers, 0) or em.run_bwd.launches:
        raise AssertionError(f"one dipole call should launch #1 {layers} times and nothing else, got {launches}")
    if mu.shape != (batch.num_mol, 1) or not torch.isfinite(mu).all() or not bool((mu > 0).all()):
        raise AssertionError(f"unexpected dipole moments {tuple(mu.shape)}")
    tols = dict.fromkeys(("fused vs composable fp32", "rotated molecules", "translated"), FWD_TOL)
    errs = {"fused vs composable fp32": err(mu, serve(comp, batch)),
            "rotated molecules": err(serve(fused, _rotate_molecules(batch, SEED + 1)), mu)}
    shift = torch.tensor([3.7, -2.1, 5.3], device="cuda")
    errs["translated"] = err(serve(fused, batch.replace(pos=torch.where(batch.atom_mask[:, None],
                                                                        batch.pos + shift, batch.pos))), mu)
    ms = host_ms(lambda: serve(fused, batch))
    comp_ms = host_ms(lambda: serve(comp, batch))
    dipole = fused
    del fused, comp
    # the fused dipole's gap to composable fp32 for the weights of more seeds
    seed_errs = {SEED: errs["fused vs composable fp32"]}
    for seed in DIPOLE_SEEDS[1:]:
        fused, comp = pair(DIPOLE_ARGS, seed)
        seed_errs[seed] = err(serve(fused, batch), serve(comp, batch))
        del fused, comp
    log(f"ET-QM9 dipole, fused bf16 against composable fp32 by weight seed: "
        + ", ".join(f"seed {k} {v:.3e}" for k, v in seed_errs.items()) + f" (tol {FWD_TOL})")
    if max(seed_errs.values()) > FWD_TOL:
        raise AssertionError(f"the fused dipole exceeds its tolerance for a seed: {seed_errs}")
    for name, tol in DIPOLE_OTHER_HEADS.items():
        fused, comp = pair(dict(DIPOLE_ARGS, output_model=name))
        out = serve(fused, batch)
        if not torch.isfinite(out).all():
            raise AssertionError(f"non-finite {name} outputs")
        key = f"{type(fused.module.output_model).__name__} vs composable"
        errs[key], tols[key] = err(out, serve(comp, batch)), tol
        del fused, comp
    fused, comp = pair(dict(TN_TRAIN_ARGS, output_model="DipoleMoment", derivative=False))
    tm.reset_launch_counts()
    tn_mu = serve(fused, tn_batch)
    torch.cuda.synchronize()
    tn_launches = tm.run_fwd.launches
    tn_err = err(tn_mu, serve(comp, tn_batch))
    if tn_launches != TN_TRAIN_ARGS["num_layers"]:
        raise AssertionError(f"TensorNet's dipole call should launch #8 once per layer, got {tn_launches}")
    del fused, comp

    # #1 at this shape: the kernel, its plain version, its bound
    a = DIPOLE_ARGS
    h, heads, rbf = a["embedding_dimension"], a["num_heads"], a["num_rbf"]
    nbl, ins, _ = _kernel_inputs(None, a["max_num_neighbors"], h, rbf, a["cutoff_upper"], SEED, batch=batch)
    n, kk = nbl.idx.shape
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
    common = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]
    kw = dict(heads=heads, act="silu", attn_act="silu")
    got = em.run_fwd(nbl.idx, *common, dirs, *w, **kw)
    want = _call(em.et_messages_reference, nbl, ins, heads)
    fwd_err = max(_rel(g, r) for g, r in zip(got, want))
    fwd_abs = max(float((g - r).abs().max()) for g, r in zip(got, want))
    if fwd_err > FWD_TOL:
        raise AssertionError(f"#1 disagrees with its plain version at the dipole shape: {fwd_err}")
    fwd_ms = event_ms(lambda: em.run_fwd(nbl.idx, *common, dirs, *w, **kw), flush=flush)
    plain_ms = event_ms(lambda: _call(em.et_messages_reference, nbl, ins, heads), flush=flush)
    bound_ms, bound_by = _bounds(n, kk, h, rbf, "fwd")
    log(f"ET dipole serving at ET-QM9's widths ({layers}x{h}, {heads} heads, RBF {rbf}, K {a['max_num_neighbors']}, "
        f"fused bf16, {batch.num_mol} molecules of {TRAIN_MOL['num_atoms']} atoms, N={batch.num_atoms}): "
        f"{head}; launches #1 {launches[0]} ({layers} per call), select_topk {launches[1]} (brute list); "
        + ", ".join(f"{k} max|d|/max|ref| {v:.3e} (tol {tols[k]})" for k, v in errs.items())
        + f"; TensorNet {TN_TRAIN_ARGS['num_layers']}x{TN_TRAIN_ARGS['embedding_dimension']} "
        f"DipoleMoment on its training batch (N={tn_batch.num_atoms}): #8 {tn_launches} launches, vs composable "
        f"{tn_err:.3e} (tol {TN_FWD_TOL}); per call (host clock with sync, median of 20) {ms:.3f} ms fused, "
        f"{comp_ms:.3f} ms composable fp32; #1 at this shape (N={n} K={kk}, L2 flushed, median of 20) "
        f"{fwd_ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}), vs plain "
        f"{fwd_err:.3e}")
    if any(v > tols[k] for k, v in errs.items()) or tn_err > TN_FWD_TOL:
        raise AssertionError("the dipole and other heads disagree with their composable path or move "
                             "under a rotation or a translation")
    return launches[0], tn_launches, (fwd_ms, plain_ms, bound_ms, bound_by), fwd_abs, lambda: serve(dipole, batch)


def _prior_dataset():
    """SyntheticMorse's molecules (TRAIN_MOL) as an InMemoryArrays dataset with
    seeded partial charges (zero net charge a molecule) and the atomic
    numbers and scales SyntheticMorse gives its priors (0-99, A, eV)."""
    import numpy as np

    from torchmdnet_tpu_torch.data.datasets import InMemoryArrays, SyntheticMorse

    src = SyntheticMorse(num_samples=sum(PRIOR_TRAIN_SPLIT), seed=SEED, **TRAIN_MOL)
    s, n = src.z.shape
    rng = np.random.default_rng(SEED + 7)
    pq = rng.normal(scale=0.3, size=(s, n))
    pq = (pq - pq.mean(axis=1, keepdims=True)).astype(np.float32)
    ds = InMemoryArrays(src.z.reshape(-1), src.pos.reshape(-1, 3), np.arange(0, s * n + 1, n),
                        y=src.y, neg_dy=src.neg_dy.reshape(-1, 3), pq=pq.reshape(-1))
    for key in ("atomic_number", "distance_scale", "energy_scale"):
        setattr(ds, key, getattr(src, key))
    return ds


def prior_training(workdir):
    """Phase C: force training of the training benchmark's ET with the ZBL,
    D2 and Coulomb priors through DataModule -> PaddedLoader -> Trainer (one
    epoch: three steps and a validation batch of 64 molecules), the priors'
    arguments taken from the dataset and Coulomb's charges from its ``pq``.
    Checks: the first batch's prior checks pass (fit makes them), losses
    finite, #1 once, #2 twice and #3 once per layer per step; then one
    force-loss gradient against the composable fp32 path
    (``train_grads_vs_composable``).  Returns (the fit's (fwd, bwd, bwd2,
    select_topk) launches, the trainer, the dataset, the gradient's
    configuration)."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.models.potential import create_prior_models
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.train.trainer import Trainer

    ds = _prior_dataset()
    train, val, test = PRIOR_TRAIN_SPLIT
    h = dict(TRAIN_ARGS, prior_model=PRIOR_TRAIN_PRIORS, batch_size=PRIOR_TRAIN_BATCH,
             inference_batch_size=PRIOR_TRAIN_BATCH, num_epochs=1, train_size=train, val_size=val,
             test_size=test, lr=1e-4, y_weight=1.0, neg_dy_weight=1.0, seed=SEED, num_workers=0,
             log_dir=os.path.join(workdir, "logs"), save_interval=1)
    t0 = time.perf_counter()
    data = DataModule(h, dataset=ds)
    data.setup()
    priors = create_prior_models(h, data.dataset)
    h["prior_args"] = [p.get_init_args() for p in priors]
    model = create_model(h, priors, mean=data.mean, std=data.std, seed=SEED)
    names = [type(p).__name__ for p in model.module.priors]
    if names != PRIOR_TRAIN_PRIORS or model.module.priors[0].atomic_number != tuple(range(100)):
        raise AssertionError(f"the priors did not take the dataset's arguments: {h['prior_args']}")
    trainer = Trainer(model, h)
    _reset_launches()
    trainer.fit(data)
    torch.cuda.synchronize()
    launches = _launches(em)
    seconds = time.perf_counter() - t0
    with open(os.path.join(h["log_dir"], "metrics.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r.get("train_total_mse_loss")]
    losses = [float(rows[-1][k]) for k in ("train_total_mse_loss", "val_total_mse_loss")] + [trainer.first_step_loss]
    if not rows or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training with priors gave non-finite losses: {rows}")
    layers = TRAIN_ARGS["num_layers"]
    steps, evals = train // PRIOR_TRAIN_BATCH, -(-val // PRIOR_TRAIN_BATCH)
    expected = (layers * (steps + evals), layers * (2 * steps + evals), layers * steps, 0)
    if launches != expected or trainer.state.global_step != steps:
        raise AssertionError(f"expected launches {expected} for {steps} steps and {evals} evaluation batches "
                             f"with the priors, got {launches}")
    _check_et_parts("prior_train", launches[1], launches[2])
    charges = data.train_dataloader()
    first = next(iter(charges))
    log(f"force training with priors {names} (DataModule -> PaddedLoader -> Trainer, {TRAIN_ARGS['num_layers']}x"
        f"{TRAIN_ARGS['embedding_dimension']} fused bf16, batches of {PRIOR_TRAIN_BATCH} molecules, "
        f"N={first.num_atoms}, partial charges collated: {sorted(first.extra)}, net charge per molecule "
        f"max |{float(np.abs(np.add.reduceat(ds.pq, ds.offsets[:-1])).max()):.2e}|): prior args, atomic numbers "
        f"0-99 from the dataset and "
        f"{json.dumps([{k: v for k, v in a.items() if k != 'atomic_number'} for a in h['prior_args']])}; "
        f"first-batch prior checks passed; first step loss "
        f"{trainer.first_step_loss:.4f}, train {losses[0]:.4f}, val {losses[1]:.4f}; launches fwd {launches[0]} "
        f"bwd {launches[1]} bwd2 {launches[2]} select_topk {launches[3]} ({steps} steps x (1, 2, 1) x L + {evals} "
        f"evaluation batch x (1, 1, 0) x L, L={layers}); {seconds:.1f} s in all")
    cfg = dict(_train_cfg("et"), args=dict(TRAIN_ARGS, prior_model=PRIOR_TRAIN_PRIORS, prior_args=h["prior_args"]),
               batch=PRIOR_TRAIN_BATCH, label=f"ET {layers}x{TRAIN_ARGS['embedding_dimension']} with "
               f"{'/'.join(names)}")
    train_grads_vs_composable(ds, cfg)
    return launches, trainer, ds, cfg


# --- examples/ET-MD17.yaml from an rMD17-format file, and its checkpoint ----
# served back through the reference-checkpoint import

MD17_CONF = os.path.join("examples", "ET-MD17.yaml")
MD17_MOLECULE = "revised_aspirin"
# rMD17's aspirin, its atomic numbers in the file's order (C9H8O4)
ASPIRIN_Z = (6, 6, 6, 6, 6, 6, 6, 8, 8, 8, 6, 6, 8, 1, 1, 1, 1, 1, 1, 1, 1)
# SyntheticMorse frames of 21 atoms in a 6.3 A cell (GN_TRAIN_MOL's 2 A spacing)
MD17_MOL = dict(num_atoms=21, cell=6.3)
# cuts of the configuration, each named in the phase's line: the yaml trains
# on 950 / 50 frames (the test set is the rest of rMD17's 100,000) for
# 10,000 epochs after 1000 warmup steps, with a checkpoint every 10 epochs
MD17_SPLIT = (192, 32, 32)  # 24 training batches of 8, one val batch, one test batch of 64
MD17_EPOCHS = 2
MD17_WARMUP_STEPS = 10
MD17_SAVE_INTERVAL = 1
MD17_KERNELS = ("et_fwd_kernel", "et_bwd_kernel", "et_bwd2_kernel", "et_bwd_src_kernel", "et_bwd2_src_kernel",
                "et_dw_kernel")


def write_rmd17(root):
    """MD17_SPLIT's frames of one molecule with aspirin's atomic numbers,
    labelled by SyntheticMorse's Morse energies and forces, as rMD17 ships
    them (``<root>/raw/rmd17/npz_data/rmd17_aspirin.npz``: nuclear_charges,
    coords, energies, forces, old_indices, old_energies, old_forces), and
    the same frames as Custom's npy files under ``<root>/custom``.  Returns
    Custom's globs."""
    import numpy as np

    from torchmdnet_tpu_torch.data.datasets import MD17, SyntheticMorse

    frames = sum(MD17_SPLIT)
    morse = SyntheticMorse(num_samples=frames, atom_types=(1, 6, 8), seed=SEED, **MD17_MOL)
    z = np.asarray(ASPIRIN_Z, dtype=np.int64)
    coords = morse.pos.astype(np.float64)
    labels = [morse._energy_forces(z, p) for p in coords]
    energies = np.array([e for e, _ in labels])
    forces = np.stack([f for _, f in labels])
    raw = os.path.join(root, "raw", "rmd17", "npz_data")
    os.makedirs(raw)
    np.savez(os.path.join(raw, MD17.file_names[MD17_MOLECULE]), nuclear_charges=z, coords=coords,
             energies=energies, forces=forces, old_indices=np.arange(frames), old_energies=energies,
             old_forces=forces)
    custom = os.path.join(root, "custom")
    os.makedirs(custom)
    for name, value in (("coord", coords), ("embed", z), ("energy", energies[:, None]), ("force", forces)):
        np.save(os.path.join(custom, f"{name}_0.npy"), value)
    return {f"{name}glob": os.path.join(custom, f"{name}_*.npy") for name in ("coord", "embed", "energy", "force")}


def md17_training(workdir):
    """examples/ET-MD17.yaml at its widths (6 x 128, 8 heads, 32 RBFs,
    cutoff 5 A, 32 neighbors, batches of 8, derivative, standardize)
    through the training CLI with the fused bf16 edge phase, on an
    rMD17-format file that ``MD17("revised_aspirin")`` reads through
    DataModule and the loader.  Checks: the same frames through Custom's
    npy files equal MD17's samples bitwise; losses finite and falling; #1
    once, #2 twice and #3 once per layer per step (plus the evaluations);
    the checkpoint reloads.  Then the loader's share of an epoch's wall.
    Returns ((fwd, bwd, bwd2, select_topk) launches, the trainer, a
    training batch, the best checkpoint's path)."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch.data.datasets import MD17, Custom
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.scripts import train as cli

    root = os.path.join(workdir, "data")
    globs = write_rmd17(root)
    md17, custom = MD17(root, molecules=MD17_MOLECULE), Custom(**globs)
    if len(md17) != len(custom) or not np.array_equal(md17.sample_sizes(), custom.sample_sizes()):
        raise AssertionError("MD17 and Custom read different frame counts from the same frames")
    for i in range(len(md17)):
        a, b = md17[i], custom[i]
        if sorted(a) != sorted(b) or any(a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"frame {i}: MD17 and Custom samples differ")
    train, val, test = MD17_SPLIT
    logs = os.path.join(workdir, "logs")
    flags = ["--conf", os.path.join(ROOT, MD17_CONF), "--dataset-root", root,
             "--dataset-arg", json.dumps({"molecules": MD17_MOLECULE}), "--train-size", str(train),
             "--val-size", str(val), "--test-size", str(test), "--num-epochs", str(MD17_EPOCHS),
             "--lr-warmup-steps", str(MD17_WARMUP_STEPS), "--save-interval", str(MD17_SAVE_INTERVAL),
             "--fused-attention", "true", "--bf16-messages", "true", "--seed", str(SEED), "--log-dir", logs]
    t0 = time.perf_counter()
    _reset_launches()
    trainer, test_metrics = cli.main(flags)
    torch.cuda.synchronize()
    launches = _launches(em)
    seconds = time.perf_counter() - t0
    h = trainer.h
    widths = {k: h[k] for k in ("embedding_dimension", "num_layers", "num_heads", "num_rbf", "cutoff_upper",
                                "max_num_neighbors", "batch_size", "derivative", "standardize")}
    if widths != dict(embedding_dimension=128, num_layers=6, num_heads=8, num_rbf=32, cutoff_upper=5.0,
                      max_num_neighbors=32, batch_size=8, derivative=True, standardize=True):
        raise AssertionError(f"ET-MD17's widths did not reach the trainer: {widths}")
    if (h["dataset"], h["dataset_arg"]) != ("MD17", {"molecules": MD17_MOLECULE}):
        raise AssertionError(f"the CLI did not read the rMD17 file through MD17: {h['dataset']}, {h['dataset_arg']}")
    with open(os.path.join(logs, "metrics.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r.get("train_total_mse_loss")]
    train_losses = [float(r["train_total_mse_loss"]) for r in rows]
    first = trainer.first_step_loss
    values = train_losses + [first] + [float(v) for v in test_metrics.values()]
    if len(rows) != MD17_EPOCHS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"ET-MD17 training losses missing or not finite: {rows}, {test_metrics}")
    if not train_losses[-1] < first:
        raise AssertionError(f"ET-MD17: the last epoch's train loss {train_losses[-1]} is not below the first "
                             f"step's {first}")
    layers, bs, ibs = h["num_layers"], h["batch_size"], h["inference_batch_size"]
    steps = MD17_EPOCHS * (train // bs)
    evals = MD17_EPOCHS * -(-val // ibs) + -(-test // ibs)
    expected = (layers * (steps + evals), layers * (2 * steps + evals), layers * steps, 0)
    if launches != expected or trainer.state.global_step != steps:
        raise AssertionError(f"ET-MD17: expected launches {expected} for {steps} steps and {evals} evaluation "
                             f"batches, got {launches} after {trainer.state.global_step} steps")
    if _check_et_parts("md17_train", launches[1], launches[2])["et_message_dw"] < launches[2]:
        raise AssertionError("ET-MD17: the second order's weight reduction did not run once per launch")
    best = _check_reload(trainer)
    scale = (trainer.model.module.mean, trainer.model.module.std)
    log(f"ET-MD17 training CLI (scripts.train.main --conf {MD17_CONF}, {layers}x{h['embedding_dimension']}, "
        f"{h['num_heads']} heads, {h['num_rbf']} RBFs, K {h['max_num_neighbors']}, batches of {bs}, fused bf16; "
        f"MD17('{MD17_MOLECULE}') on an rMD17-format file of {len(md17)} SyntheticMorse-labelled frames with "
        f"aspirin's atomic numbers, equal bitwise to Custom's npy reads; cut: splits {MD17_SPLIT} for the yaml's "
        f"950/50/rest, {MD17_EPOCHS} epochs for 10000, warmup {MD17_WARMUP_STEPS} steps for 1000, save "
        f"interval {MD17_SAVE_INTERVAL} for 10): first step loss {first:.4f}, epoch train losses "
        f"{[round(v, 4) for v in train_losses]}, test {json.dumps({k: round(v, 4) for k, v in test_metrics.items()})}"
        f"; launches fwd {launches[0]} bwd {launches[1]} bwd2 {launches[2]} select_topk {launches[3]} ({steps} "
        f"steps x (1, 2, 1) x L + {evals} evaluation batches x (1, 1, 0) x L, L={layers}); checkpoint "
        f"{os.path.basename(best)} reloads with its mean {scale[0]:.4f} and std {scale[1]:.4f}; {seconds:.1f} s "
        f"in all")
    batch = loader_share(trainer, workdir)
    return launches, trainer, batch, best


def loader_share(trainer, workdir):
    """The loader's share of an ET-MD17 training epoch's wall: one epoch of
    the training loader alone (collation into a padded batch built on the
    card, so the host-to-device copy is in it) against one epoch of
    training steps on it, without prefetch (num_workers 0) and with the
    yaml's (num_workers 6: a thread collates two batches ahead); host clock
    with a sync at each end, the second of two rounds.  Returns a training
    batch on the card."""
    import torch

    from torchmdnet_tpu_torch.data.datasets import MD17
    from torchmdnet_tpu_torch.data.module import DataModule

    h = trainer.h
    loaders = {}
    for workers in (0, h["num_workers"]):
        data = DataModule(dict(h, num_workers=workers, log_dir=os.path.join(workdir, f"loader{workers}")))
        data.setup()
        if not isinstance(data.dataset, MD17):
            raise AssertionError(f"DataModule read {type(data.dataset).__name__}, not MD17")
        loaders[workers] = data.train_dataloader()
    acc = torch.zeros(4, dtype=trainer.dtype, device="cuda")
    ema = torch.zeros((), dtype=trainer.dtype, device="cuda")

    def epoch(loader, train):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for b in loader:
            if train:
                trainer._train_step(trainer._prepare_batch(b), acc, ema, ema)
            n += 1
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), n

    rounds = []
    for _ in range(2):
        rounds.append({"loader": epoch(loaders[0], False), "steps": epoch(loaders[0], True),
                       "steps, prefetch": epoch(loaders[h["num_workers"]], True)})
    last = rounds[-1]
    n = last["loader"][1]
    share = last["loader"][0] / last["steps"][0]
    log(f"ET-MD17 epoch ({n} batches of {h['batch_size']}, host clock with sync, second of two rounds): loader "
        f"alone (collation + host-to-device) {last['loader'][0]:.3f} ms ({last['loader'][0] / n:.3f} ms/batch); "
        f"training epoch {last['steps'][0]:.3f} ms without prefetch, {last['steps, prefetch'][0]:.3f} ms with "
        f"num_workers {h['num_workers']} (prefetch thread); loader share of the epoch {100 * share:.1f}% "
        f"(first round: loader {rounds[0]['loader'][0]:.3f} ms, epoch {rounds[0]['steps'][0]:.3f} ms, with "
        f"prefetch {rounds[0]['steps, prefetch'][0]:.3f} ms)")
    return trainer._prepare_batch(next(iter(loaders[0])))


def reference_checkpoint(path, out):
    """The port checkpoint at ``path`` re-expressed as an upstream
    torchmd-net Lightning checkpoint at ``out``: the ``model.`` prefix, the
    reference's per-head order of ET's v/dv projection rows and (H, 3)
    interleave of TensorNet's interaction filter (the inverses of the
    permutations ``tools/import_torch.py`` applies), Atomref's table as
    ``prior_model.{i}.atomref.weight``, the standardization's mean and std
    as the reference's ``mean``/``std`` buffers, and ``hyper_parameters``."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch.models.et import vproj_column_perm
    from torchmdnet_tpu_torch.models.tensornet import wproj_column_perm
    from torchmdnet_tpu_torch.train.checkpoints import load_checkpoint

    ckpt = load_checkpoint(path)
    args = ckpt["hyper_parameters"]
    h = args["embedding_dimension"]
    inverse = None
    if args["model"] == "equivariant-transformer":
        inverse = torch.as_tensor(np.argsort(vproj_column_perm(h, args["num_heads"])))
    elif args["model"] == "tensornet":
        inverse = torch.as_tensor(np.argsort(wproj_column_perm(h)))
    sd = {}
    for key, value in ckpt["state_dict"].items():
        parts = key.split(".")
        if inverse is not None and (parts[-2] in ("v_proj", "dv_proj") or
                                    (args["model"] == "tensornet" and ".layers." in key
                                     and ".linears_scalar.2." in key)):
            value = value[inverse]
        if parts[0] == "priors":
            key = f"prior_model.{parts[1]}.{parts[2]}.weight"
        sd["model." + key] = value.clone()
    for key in ("mean", "std"):
        sd[f"model.{key}"] = torch.tensor(float(ckpt["extra"][key]), dtype=torch.float64)
    torch.save({"state_dict": sd, "hyper_parameters": dict(args), "epoch": ckpt["extra"].get("epoch", 0),
                "global_step": ckpt["extra"].get("global_step", 0)}, out)


def import_serving(best, workdir, md17_batch):
    """The trained ET-MD17 checkpoint re-expressed in the reference's layout
    and brought back through ``import_checkpoint``: its weights, and its
    energy and forces on aspirin frames and on the DHFR-sized system
    through ``External.calculate``, must be bitwise those of ``load_model``
    on the port checkpoint (the standardization's mean and std with them).
    Both take the ET DHFR phase's
    max_num_neighbors (ET-MD17's 32 at 5 A overflow at DHFR density).
    Returns the imported model's (fwd, bwd, select_topk) launches over
    REQUESTS calls."""
    import torch

    from torchmdnet_tpu_torch import External
    from torchmdnet_tpu_torch.models.potential import load_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk
    from torchmdnet_tpu_torch.tools.import_torch import import_checkpoint

    k = ET_ARGS["max_num_neighbors"]
    ref_path = os.path.join(workdir, "reference.ckpt")
    reference_checkpoint(best, ref_path)
    ported = load_model(best, max_num_neighbors=k)
    imported = import_checkpoint(ref_path, max_num_neighbors=k)
    a, b = ported.module.state_dict(), imported.module.state_dict()
    if sorted(a) != sorted(b) or not all(torch.equal(a[key], b[key]) for key in a):
        raise AssertionError("the imported weights differ from the port checkpoint's")
    scale = (imported.module.mean, imported.module.std)
    if scale != (ported.module.mean, ported.module.std) or scale == (0.0, 1.0):
        raise AssertionError(f"the standardization's mean and std did not come through: {scale}")
    e_p, f_p = ported.energy_and_forces(md17_batch)
    e_i, f_i = imported.energy_and_forces(md17_batch)
    if not (torch.equal(e_p, e_i) and torch.equal(f_p, f_i) and torch.isfinite(f_i).all()):
        raise AssertionError("the imported model's energy or forces on aspirin frames differ from the port's")
    z, _, requests = _dhfr_requests()
    results, launches = {}, None
    for name, model in (("port", ported), ("imported", imported)):
        ext = External((model, None), z[None])
        _reset_launches()
        results[name] = [tuple(t.clone() for t in ext.calculate(p)) for p in requests]
        torch.cuda.synchronize()
        if name == "imported":
            launches = (em.run_fwd.launches, em.run_bwd.launches, select_topk.launches)
            _check_et_parts("import_external_dhfr", launches[1], 0)
            call_ms = host_ms(lambda: ext.calculate(requests[0]))
    layers = imported.args["num_layers"]
    if launches != (layers * REQUESTS, layers * REQUESTS, REQUESTS + 1):
        raise AssertionError(f"imported ET-MD17 at DHFR size: expected ({layers}, {layers}) launches a request "
                             f"and {REQUESTS + 1} select_topk, got {launches}")
    for (e1, f1), (e2, f2) in zip(results["port"], results["imported"]):
        if not (torch.equal(e1, e2) and torch.equal(f1, f2) and torch.isfinite(f2).all()):
            raise AssertionError("the imported model serves other energies or forces at DHFR size than the port's")
    log(f"reference-checkpoint import (tools.import_torch.import_checkpoint) of the ET-MD17 checkpoint "
        f"re-expressed in the reference layout: weights bitwise the port checkpoint's, mean {scale[0]:.4f} and std "
        f"{scale[1]:.4f} as load_model's; energy and forces bitwise "
        f"load_model's on {md17_batch.num_mol} aspirin frames and on {REQUESTS} DHFR requests through "
        f"External.calculate (max_num_neighbors {k} for both); launches fwd {launches[0]} bwd {launches[1]} "
        f"({layers}+{layers} per request), select_topk {launches[2]}; energies "
        f"{[round(float(r[0][0]), 4) for r in results['imported']]}; {call_ms:.3f} ms/call (host clock with "
        f"sync, median of 20)")
    return launches


# --- the parallel layer: data parallelism and edge partitioning

DP_SPLIT = (64, 32, 32)  # 8 training batches of 8, one val and one test batch (of 64, split over the ranks)
DP_EPOCHS = 2
# fused bf16, one process against two ranks (each sorting its shard on the
# global batch's grid, as one process sorts the batch).  The distance
# filters (DP_BF16_FILTERS) enter the fused kernels as bf16 copies, so each
# rank's share of their gradient is rounded to bf16 before the ranks' sum,
# where one process rounds the sum once: up to half a bf16 ulp (2^-9) of
# each share and of the sum, more of a tensor's largest where shares
# cancel.  Every other gradient sums f32 shares: DP_SAME_GRAD_TOL.  The
# filters' rounding then steers 16 Adam steps apart: the epoch losses.
# Sound runs: the filters 7.353e-3 of their largest on the H100 (all
# gradients' largest gap there), 3.7e-3 on the CPU at the tests' size, with
# nothing else above 3.3e-7; losses 1.329e-2 (H100).  Planted faults (CPU,
# the tests' size): no gradient sum, or each rank's loss divided by its own
# counts, give gradients 1.07 and 1.0, losses 0.37 and 0.48.  Limits
# between: 2^-6 and 5e-2.
DP_BF16_FILTERS = ("dk_proj", "dv_proj")
DP_BF16_FILTER_GRAD_TOL = 2 ** -6
DP_BF16_LOSS_RTOL = 5e-2
# composable f32, and NCCL at world size 1 (the same batches): only the
# order of float sums differs; 16 Adam steps carry the first step's
# differences into the weights, and a loss near its minimum magnifies them
DP_SAME_GRAD_TOL = 1e-5  # of each tensor's largest value
DP_SAME_LOSS_RTOL = 1e-4
DP_TIMEOUT_S = 300
EP_ENERGY_RTOL = 1e-5  # JAX's ring test's tolerances (tests/test_ring_model.py:47-53)
EP_FORCE_TOL = 1e-4  # of the largest force
EP_REPEATS = 3
EP_MD_STEPS = 20
# Partitioned fused bf16 forces differ from one process's in their last
# bits: a rank's 1248 DHFR rows reach cuBLAS's f32 products with half the
# rows, and the input gradients of the 128 -> 384 projections ((M, 384) x
# (384, 128)) then round some rows otherwise (1.9e-8; row_count_probe; at
# STMV's row counts no op does), which flips bf16 roundings in the kernels'
# operands: 5.2e-5 of the largest force for the DHFR call, up to 1.61e-4
# over the 21 evaluations of unscaled MD on the skin list (H100).  Planted
# faults (CPU, the tests' 61 atoms): ghost rows out of order 0.75, the ghost
# receivers' cotangents dropped 0.109.  The evaluations' limit between:
EP_FUSED_FORCE_TOL = 1e-3
# Random weights give forces of hundreds of eV/A, which grow those gaps into
# 0.14 A in 20 steps: the trajectory check scales the output by EP_MD_STD
# (as GN MD at STMV scales it by 0.1), so that thermal motion (about 1.5 A
# in 20 fs for hydrogens) dominates; the evaluations are checked unscaled.
EP_MD_STD = 0.01
EP_MD_POS_TOL = 1e-3  # A
EP_TIMEOUT_S = 400
EP_BOUNDARY = 65536  # boundary edges a (rank, owner) pair may have: the library's boundary_limit
EP_MD_ARGS = dict(timestep_fs=1.0, temperature_K=300.0, friction_per_fs=0.01, neighbor_skin=MD_ARGS["neighbor_skin"],
                  rebuild_every=MD_VALID_EVERY, seed=SEED)
# the single-process ET MD peak at STMV size (PERF.md section 7), for scale
STMV_SINGLE_PEAK_GIB = 12.04


def _dp_flags(root, log_dir):
    train, val, test = DP_SPLIT
    return ["--conf", os.path.join(ROOT, MD17_CONF), "--dataset-root", root,
            "--dataset-arg", json.dumps({"molecules": MD17_MOLECULE}), "--train-size", str(train),
            "--val-size", str(val), "--test-size", str(test), "--num-epochs", str(DP_EPOCHS),
            "--lr-warmup-steps", str(MD17_WARMUP_STEPS), "--save-interval", "1", "--fused-attention", "true",
            "--bf16-messages", "true", "--seed", str(SEED), "--num-workers", "0", "--log-dir", log_dir]


# one rank of the training CLI whose trainer saves the first step's
# gradients (its on_before_optimizer_step hook):
#   python -c _RANK_DRIVER grads.pt BACKEND [CLI flags]
# BACKEND, when not empty, joins the process group on that backend first
# (nodes that share one card name gloo: NCCL refuses two ranks on a device).
# After the run each rank prints its fused kernels' launches ("rank
# launches: RANK {json}") and its peak device memory ("rank peak bytes:
# RANK BYTES")
_RANK_DRIVER = """
import json, os, sys, torch
from torchmdnet_tpu_torch.ops.kernels import et_message, t_message, tn_message
from torchmdnet_tpu_torch.parallel.distributed import initialize_distributed
from torchmdnet_tpu_torch.scripts import train as cli
from torchmdnet_tpu_torch.train.trainer import Trainer

def save(trainer):
    if trainer.state.global_step == 0 and trainer.is_main:
        torch.save({n: p.grad.detach().cpu() for n, p in zip(trainer.param_names, trainer.params)}, sys.argv[1])

Trainer.on_before_optimizer_step = save
if sys.argv[2]:
    initialize_distributed(cli.get_args(sys.argv[3:]).num_nodes, backend=sys.argv[2])
kms = {"et_message": et_message, "t_message": t_message, "tn_message": tn_message}
for km in kms.values():
    km.reset_launch_counts()
cli.main(sys.argv[3:])
rank = os.environ.get("LOCAL_RANK", os.environ.get("NODE_RANK", "0"))
counts = {f"{name}_{kind}": getattr(km, fn).launches for name, km in kms.items()
          for kind, fn in (("fwd", "run_fwd"), ("bwd", "run_bwd"), ("bwd2", "run_bwd2"), ("bwd_src", "bwd_source"),
                           ("bwd2_src", "bwd2_source")) if hasattr(km, fn)}
print("rank launches:", rank, json.dumps(counts))
if torch.cuda.is_available():
    print("rank peak bytes:", rank, torch.cuda.max_memory_allocated())
"""


def _dp_run(label, workdir, root, extra=(), env=None, ranks=0, nodes=0, backend="", flags_of=None, solo=False):
    """One training run of the DP phase: the CLI in this process (its
    trainer's hook saving the first step's gradients), or ``ranks`` local
    ranks of one node (as the CLI's launcher starts them: LOCAL_RANK,
    LOCAL_WORLD_SIZE), or ``nodes`` processes joined through the environment
    rendezvous (NODE_RANK), each running ``_RANK_DRIVER``, or (``solo``) one
    such process with no rendezvous (one process's own run, its peak memory
    its own).  ``flags_of(root, log_dir)`` gives the CLI flags (default
    ``_dp_flags``).  Returns (epoch
    rows of metrics.csv, first-step gradients, (rank 0's "fit:" line or
    None, every rank's output), seconds)."""
    import torch

    from torchmdnet_tpu_torch.parallel.distributed import free_port
    from torchmdnet_tpu_torch.scripts import train as cli
    from torchmdnet_tpu_torch.train.trainer import Trainer

    log_dir = os.path.join(workdir, label)
    grads = os.path.join(workdir, f"{label}_grads.pt")
    flags = (flags_of or _dp_flags)(root, log_dir) + list(extra)
    base = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    t0 = time.perf_counter()
    fit = None
    if ranks or nodes or solo:
        common = dict(base, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        envs = ([dict(common, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks)) for r in range(ranks)]
                + [dict(common, NODE_RANK=str(r)) for r in range(nodes)])
        if solo:
            envs = [{k: v for k, v in base.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "NODE_RANK",
                                                                "LOCAL_RANK", "LOCAL_WORLD_SIZE")}]
        procs = [subprocess.Popen([sys.executable, "-c", _RANK_DRIVER, grads, backend] + flags, env=e,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for e in envs]
        try:
            outs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError(f"DP {label}: a rank failed:\n" + "\n".join(o[-3000:] for o in outs))
        text = "\n".join(outs)
    else:
        import contextlib
        import io

        def save(trainer):
            if trainer.state.global_step == 0 and trainer.is_main:
                torch.save({n: p.grad.detach().cpu() for n, p in zip(trainer.param_names, trainer.params)}, grads)

        saved = {k: os.environ.get(k) for k in base}
        os.environ.update(base)
        out = io.StringIO()
        hook = Trainer.on_before_optimizer_step
        Trainer.on_before_optimizer_step = save
        try:
            with contextlib.redirect_stdout(out):
                cli.main(flags)
        finally:
            Trainer.on_before_optimizer_step = hook
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        torch.cuda.synchronize()
        text = out.getvalue()
    seconds = time.perf_counter() - t0
    for line in text.splitlines():
        if line.startswith("fit:"):
            fit = line
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        rows = [{k: float(v) for k, v in r.items() if v not in ("", None)} for r in csv.DictReader(f)]
    return rows, torch.load(grads), (fit, text), seconds


def _grad_gap(a, b, keys=None):
    """The largest |a - b| of a gradient tensor over its largest |a|, over
    the tensors ``keys`` (all by default)."""
    return max((float((a[k] - b[k]).abs().max()) / max(float(a[k].abs().max()), 1e-30) for k in (keys or a)),
               default=0.0)


def _rows_gap(a, b):
    """(the largest relative gap between two runs' logged metrics, its key)."""
    if len(a) != len(b) or any(x.keys() != y.keys() for x, y in zip(a, b)):
        raise AssertionError(f"the runs logged different metrics: {a} / {b}")
    gaps = [(abs(x[k] - y[k]) / max(abs(x[k]), 1e-30), k) for x, y in zip(a, b) for k in x if k != "epoch"]
    return max(gaps)


def dp_training(workdir):
    """(G-DP) examples/ET-MD17.yaml through the CLI, each run against one
    process on the same global batches:

    - fused bf16 (the yaml's path on the card): ``--ndevices 2`` (two
      local ranks of one node on the one card, gloo; each rank sorts its
      shard on the global batch's grid, so every molecule's atoms take the
      order they take in one process), DP_BF16_* (the filters' gradients)
      and DP_SAME_* (the rest); and one process through
      the rendezvous (MASTER_ADDR set): a data-parallel run on NCCL at world
      size 1 over the same batches (DP_SAME_*), whose launches are the
      ``dp_nccl_train`` path;
    - composable f32: ``--num-nodes 2 --ndevices 1``, two processes joined
      through MASTER_ADDR / MASTER_PORT / NODE_RANK (gloo, named: the nodes
      share the card; the gradients summed through host copies), DP_SAME_*.

    Each run logs its epoch losses, and its trainer's hook saves the
    first step's gradients.  Returns the NCCL run's (fwd, bwd, bwd2,
    select_topk) launches."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.parallel.distributed import free_port

    root = os.path.join(workdir, "data")
    write_rmd17(root)
    f32 = ("--fused-attention", "false", "--bf16-messages", "false")
    one, g1, (fit1, _), s1 = _dp_run("one", workdir, root)
    two, g2, (fit2, text2), s2 = _dp_run("ranks", workdir, root, extra=("--ndevices", "2"), ranks=2)
    _reset_launches()
    nccl, g4, (fit4, text4), s4 = _dp_run("nccl", workdir, root,
                                          env=dict(MASTER_ADDR="localhost", MASTER_PORT=str(free_port())))
    launches = _launches(em)
    parts = _check_et_parts("dp_nccl_train", launches[1], launches[2])
    one32, g5, (fit5, _), s5 = _dp_run("one_f32", workdir, root, extra=f32)
    nodes, g3, (fit3, _), s3 = _dp_run("nodes_f32", workdir, root, extra=("--num-nodes", "2", "--ndevices", "1") + f32,
                                      nodes=2, backend="gloo")
    backend = [ln for ln in text2.splitlines() if ln.startswith("data parallel:")]
    if not backend or "2 ranks over the gloo backend" not in backend[0]:
        raise AssertionError(f"DP: the two-rank run did not report its gloo backend: {backend}")
    nccl_backend = [ln for ln in text4.splitlines() if ln.startswith("data parallel:")]
    if not nccl_backend or "1 ranks over the nccl backend" not in nccl_backend[0]:
        raise AssertionError(f"DP: the rendezvous run at world size 1 did not train on NCCL: {nccl_backend}")
    filters = [k for k in g1 if any(f in k for f in DP_BF16_FILTERS)]
    others = [k for k in g1 if k not in filters]
    if not filters or g1.keys() != g2.keys():
        raise AssertionError(f"DP: unexpected gradient names {sorted(g1)} / {sorted(g2)}")
    filter_gap = _grad_gap(g1, g2, filters)
    gaps = dict(ranks=(_rows_gap(one, two), _grad_gap(g1, g2, others)), nccl=(_rows_gap(one, nccl), _grad_gap(g1, g4)),
                nodes=(_rows_gap(one32, nodes), _grad_gap(g5, g3)))
    text = "; ".join(f"{k}: losses {v[0][0]:.3e} ({v[0][1]}), gradients {v[1]:.3e}" for k, v in gaps.items())
    text += f" (ranks: the {len(others)} gradients but the {len(filters)} filters'; theirs {filter_gap:.3e})"
    if (gaps["ranks"][0][0] > DP_BF16_LOSS_RTOL or gaps["ranks"][1] > DP_SAME_GRAD_TOL
            or filter_gap > DP_BF16_FILTER_GRAD_TOL
            or any(gaps[k][0][0] > DP_SAME_LOSS_RTOL or gaps[k][1] > DP_SAME_GRAD_TOL for k in ("nccl", "nodes"))):
        raise AssertionError(f"DP: a data-parallel run disagrees with one process: {text}")
    train, val, test = DP_SPLIT
    steps = DP_EPOCHS * train // 8
    layers = 6
    evals = DP_EPOCHS + 1  # one validation batch an epoch and one test batch, each of 64 molecule slots
    expected = (layers * (steps + evals), layers * (2 * steps + evals), layers * steps, 0)
    if launches != expected or parts["et_message_dw"] < launches[2]:
        raise AssertionError(f"DP NCCL run: expected launches {expected}, got {launches}, {parts}")
    epochs = [r for r in one if "train_total_mse_loss" in r]
    log(f"data-parallel training (G-DP; examples/ET-MD17.yaml, splits {DP_SPLIT}, {DP_EPOCHS} epochs, {steps} steps "
        f"of 8 molecules; gaps: the largest relative loss gap over the logged metrics, and the first step's "
        f"gradients over each tensor's largest): fused bf16 one process {s1:.1f} s [{fit1}], epoch train losses "
        f"{[round(r['train_total_mse_loss'], 5) for r in epochs]}; --ndevices 2 ({backend[0]}) {s2:.1f} s [{fit2}] "
        f"(tol {DP_BF16_LOSS_RTOL} / {DP_SAME_GRAD_TOL}, filters {DP_BF16_FILTER_GRAD_TOL}); NCCL at world size 1 {s4:.1f} s [{fit4}] (tol {DP_SAME_LOSS_RTOL} / {DP_SAME_GRAD_TOL}), "
        f"launches fwd {launches[0]} bwd {launches[1]} bwd2 {launches[2]} ({steps} steps x (1, 2, 1) x {layers} + "
        f"{evals} evaluation batches x (1, 1, 0) x {layers}); composable f32 one process {s5:.1f} s [{fit5}], "
        f"--num-nodes 2 through MASTER_ADDR/NODE_RANK (gloo) {s3:.1f} s [{fit3}] (tol {DP_SAME_LOSS_RTOL} / "
        f"{DP_SAME_GRAD_TOL}); {text}")
    return launches


def _spec_case(name, kind, batch, **kw):
    import dataclasses

    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    return dict(name=name, kind=kind, args=ET_ARGS, seed=SEED, batch={k: v.cpu() if hasattr(v, "cpu") else v
                                                                          for k, v in fields.items()}, **kw)


def _ranks(workdir, cases, label, timeout):
    """Run ``cases`` on two ranks of ``tools/partition_run.py``; their outputs."""
    import torch

    spec = os.path.join(workdir, f"{label}.pt")
    torch.save({"cases": cases}, spec)
    from torchmdnet_tpu_torch.parallel.distributed import launch

    rc = launch(["-m", "torchmdnet_tpu_torch.tools.partition_run", "--spec", spec, "--out",
                 os.path.join(workdir, label + "_{rank}.pt")], 2, env=dict(os.environ, PYTHONPATH=ROOT),
                timeout=timeout)
    if rc != 0:
        raise AssertionError(f"{label}: a rank failed with exit code {rc}")
    return [torch.load(os.path.join(workdir, f"{label}_{r}.pt"), weights_only=False) for r in range(2)]


def check_shard_kernels(batch, nbl, ranks=2):
    """#1 and #2's wrappers at the shapes each rank of an edge-partitioned
    call gives them (``ext=True``: the source tables with the ghost rows after
    the rank's own, the source pass over the receiver tables with the ghost
    receivers after them), each against its plain version on the same
    inputs, and against those rows of the one-process call (same values in
    each row: bitwise expected).  The receiver pass is also held against its
    plain version at the one-process shape, as a baseline.  The exchange is
    done here by indexing: each rank's tables are assembled from the global
    ones through the plans that the ranks build.  Returns {rank: (local
    rows, ghost source rows, ghost receiver rows)} and the log text."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.parallel.edge_partition import make_ring_plan
    from torchmdnet_tpu_torch.parallel.mesh import Mesh

    h, heads, rbf = ET_ARGS["embedding_dimension"], ET_ARGS["num_heads"], ET_ARGS["num_rbf"]
    _, t, (ct_x, ct_vec) = _kernel_inputs(None, nbl.idx.shape[1], h, rbf, ET_ARGS["cutoff_upper"], SEED,
                                          batch=batch, nbl=nbl)
    kw = dict(heads=heads, act="silu", attn_act="silu")
    n, kk = nbl.idx.shape
    nl = n // ranks
    dev = nbl.idx.device
    plans = [make_ring_plan(nbl.idx, Mesh(size=ranks, rank=r, device=dev, backend="none")) for r in range(ranks)]
    w = [t[x] for x in ("wdk", "bdk", "wdv", "bdv")]
    src_names, rx_names = ("k", "v", "vec0", "vec1", "vec2"), ("q", "ea", "cutm", "msk", "dir0", "dir1", "dir2")
    dirs = (t["dir0"], t["dir1"], t["dir2"])
    recv_args = (t["q"], *[t[x] for x in src_names], t["ea"], t["cutm"], t["msk"], dirs, *w, ct_x, ct_vec)
    x_all, v_all = em.run_fwd(nbl.idx, *recv_args[:9], dirs, *w, **kw)
    recv_all = em.bwd_receiver(nbl.idx, *recv_args, want_dpre=False, **kw)
    recv_all_p = em.bwd_receiver_reference(nbl.idx, *recv_args, want_dpre=False, **kw)
    src_all = em.bwd_source(nbl.idx, nbl.transpose_perm, *recv_args[:10], *w, ct_x, ct_vec, recv_all[4], **kw)

    def recv_outs(r):  # dq, dea, dcutm, ddir0..2, hs
        return [r[0], r[1], r[2], *r[3], r[4]]

    with torch.no_grad():
        x_all_p, v_all_p = em.et_messages_reference(nbl.idx, *recv_args[:9], *dirs, *w, perm=nbl.transpose_perm, **kw)
    rel = {"fwd_one_process": max(_rel(x_all, x_all_p), _rel(v_all, v_all_p)),
           "recv_one_process": max(_rel(a, b) for a, b in zip(recv_outs(recv_all), recv_outs(recv_all_p)))}
    same, shapes, rank_tabs, recv = {}, {}, [], []
    for r in range(ranks):
        rows = torch.arange(r * nl, (r + 1) * nl, device=dev)
        g_src = torch.cat([plans[o].src_send[r] + o * nl for o in range(ranks) if o != r])
        g_rx = torch.cat([plans[o].rx_send[r] + o * nl for o in range(ranks) if o != r])
        if g_src.numel() != plans[r].ghost_rows or g_rx.numel() != sum(plans[r].rx_recv):
            raise AssertionError(f"rank {r}: the plans' ghost counts disagree")
        shapes[r] = (nl, g_src.numel(), g_rx.numel())
        srcs = [t[x][torch.cat([rows, g_src])].contiguous() for x in src_names]
        loc = {x: t[x][rows].contiguous() for x in rx_names}
        ldirs = (loc["dir0"], loc["dir1"], loc["dir2"])
        lidx = plans[r].lidx
        args = (loc["q"], *srcs, loc["ea"], loc["cutm"], loc["msk"], ldirs, *w, ct_x[rows].contiguous(),
                ct_vec[rows].contiguous())
        x_k, v_k = em.run_fwd(lidx, *args[:9], ldirs, *w, ext=True, **kw)
        with torch.no_grad():
            x_p, v_p = em.et_messages_reference(lidx, *args[:9], *ldirs, *w, perm=plans[r].perm_rx, **kw)
        rk = em.bwd_receiver(lidx, *args, want_dpre=False, ext=True, **kw)
        rp = em.bwd_receiver_reference(lidx, *args, want_dpre=False, **kw)
        recv.append(rk)
        rank_tabs.append((rows, g_rx, srcs))
        rel[f"fwd_rank{r}"] = max(_rel(x_k, x_p), _rel(v_k, v_p))
        rel[f"recv_rank{r}"] = max(_rel(a, b) for a, b in zip(recv_outs(rk), recv_outs(rp)))
        slots = (rows[:, None] * kk + torch.arange(kk, device=dev)).reshape(-1)
        same[f"fwd_rank{r}"] = bool(torch.equal(x_k, x_all[rows]) and torch.equal(v_k, v_all[rows]))
        same[f"recv_rank{r}"] = all(torch.equal(a, b[rows]) for a, b in zip(recv_outs(rk)[:-1], recv_outs(recv_all)))
        same[f"recv_rank{r}"] &= bool(torch.equal(rk[4], recv_all[4][slots]))
    for r in range(ranks):
        rows, g_rx, srcs = rank_tabs[r]
        rx = torch.cat([rows, g_rx])
        hs_rx = torch.cat([recv[r][4]] + [recv[o][4].reshape(nl, kk, 2, heads)[plans[o].rx_send[r]].reshape(-1, 2, heads)
                                          for o in range(ranks) if o != r]).contiguous()
        q_rx, ea_rx, msk_rx = (t[x][rx].contiguous() for x in ("q", "ea", "msk"))
        dirs_rx = tuple(d[rx].contiguous() for d in dirs)
        cts_rx = (ct_x[rx].contiguous(), ct_vec[rx].contiguous())
        got = em.bwd_source(plans[r].lidx, plans[r].perm_rx, q_rx, *srcs, ea_rx, msk_rx, msk_rx, dirs_rx, *w, *cts_rx,
                            hs_rx, ext=True, **kw)
        want = em.bwd_source_reference(plans[r].lidx, plans[r].perm_rx, q_rx, *srcs, ea_rx, msk_rx, dirs_rx, *w,
                                       *cts_rx, hs_rx, heads=heads, act="silu")
        rel[f"src_rank{r}"] = max(_rel(a, b) for a, b in zip(got, want))
        same[f"src_rank{r}"] = all(torch.equal(a, b[rows]) for a, b in zip(got, src_all))
    torch.cuda.synchronize()
    text = (f"#1/#2 wrappers at each rank's shapes (N={n} K={kk}: " + ", ".join(
        f"rank {r} {a} rows, {b} ghost source rows, {c} ghost receivers" for r, (a, b, c) in shapes.items())
        + f"), against their plain versions (tol fwd {FWD_TOL}, passes {PART_TOL}): {_fmt(rel)}; bitwise those rows "
        f"of the one-process call: {json.dumps(same)}")
    bad = [k for k, v in rel.items() if v > (FWD_TOL if k.startswith("fwd") else PART_TOL)]
    if bad:
        raise AssertionError(f"G-EP: a kernel disagrees with its plain version at the partitioned shapes: {text}")
    return shapes, text


def row_count_probe(model, batch, nbl, parts=2):
    """Which ops of one energy+forces call give a row other bits when they run
    on a rank's rows alone.  Under a dispatch mode, every aten matmul,
    reduction over a later axis, norm or softmax whose output's first axis is
    the N atoms or the N*K slots is rerun on the first 1/``parts`` of those
    rows (rank 0's rows of a partitioned call) of each operand with that
    first axis, and compared bitwise with those rows of its output.  Returns
    {op and operand shapes: [calls checked, calls differing, largest gap]}."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    row_ops = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.sum.dim_IntList, aten.mean.dim,
               aten.native_layer_norm.default, aten.native_layer_norm_backward.default, aten._softmax.default,
               aten._softmax_backward_data.default, aten.linalg_vector_norm.default, aten.amax.default}
    n, kk = nbl.idx.shape
    sizes = {n, n * kk}
    found = {}

    dim_at = {aten.sum.dim_IntList: 1, aten.mean.dim: 1, aten.amax.default: 1, aten.linalg_vector_norm.default: 2,
              aten._softmax.default: 1, aten._softmax_backward_data.default: 2}

    def reduces_rows(func, args, kwargs):
        """Whether the op mixes rows (it reduces or normalises over axis 0)."""
        if func not in dim_at:
            return False
        at = dim_at[func]
        dims = args[at] if len(args) > at else kwargs.get("dim")
        dims = [dims] if isinstance(dims, int) else dims
        return not dims or any(d % args[0].dim() == 0 for d in dims)

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            first = out[0] if isinstance(out, (tuple, list)) else out
            if (func in row_ops and isinstance(first, torch.Tensor) and first.dim() >= 1 and first.shape[0] in sizes
                    and not reduces_rows(func, args, kwargs)):
                m = first.shape[0]
                part = m // parts

                def cut(a):
                    return a[:part] if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == m else a

                sub = func(*[cut(a) for a in args], **{k: cut(v) for k, v in kwargs.items()})
                pairs = zip(sub, out) if isinstance(out, (tuple, list)) else [(sub, out)]
                gap = max((float((a.double() - b[:part].double()).abs().max()) for a, b in pairs
                           if isinstance(a, torch.Tensor) and a.dim() >= 1 and b.shape[0] == m), default=0.0)
                key = f"{func.__name__}{[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]}"
                rec = found.setdefault(key, [0, 0, 0.0])
                rec[0] += 1
                rec[1] += gap > 0
                rec[2] = max(rec[2], gap)
            return out

    pos = batch.pos.detach().requires_grad_(True)
    with Probe():
        y = model.module(batch.replace(pos=pos), None, nbl)
        (g,) = torch.autograd.grad(y.sum(), pos)
    torch.cuda.synchronize()
    return found


def _probe_text(found):
    diff = {k: v for k, v in found.items() if v[1]}
    return (f"{sum(v[0] for v in found.values())} calls of {len(found)} op shapes checked, "
            f"{len(diff)} give rows other bits: " + (json.dumps({k: [v[0], v[1], float(f'{v[2]:.3e}')]
                                                                  for k, v in diff.items()}) if diff else "none"))


def edge_partition(workdir):
    """(G-EP, G-MD) ET 6 x 128 fused bf16 (K 80) edge-partitioned over two
    ranks of the one card (gloo): energy and forces at DHFR size against
    one process, every rank launching #1/#2, and #1/#2's wrappers at each
    rank's shapes against their plain versions; one STMV energy+forces call
    with each rank's peak memory; which ops of a one-process call give a
    rank's rows other bits (at DHFR and STMV); Simulation(mesh,
    edge_partition=True) at DHFR size for EP_MD_STEPS steps against one
    process: the trajectory with the output scaled by EP_MD_STD, and, with
    it unscaled, every force evaluation against one process's on the same
    list.  Then which gloo collectives take CUDA tensors as they are.
    Returns {path: launches} of rank 0."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch import Simulation, create_model
    from torchmdnet_tpu_torch.data.batch import spatial_sort
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    dhfr = spatial_sort(_synthetic_batch(DHFR_ATOMS, SEED, "cuda")[2])[0]
    stmv = _stmv_batch()
    model = create_model(ET_ARGS, seed=SEED)
    # the list the ranks build: cell sizes probed as ring_potential probes them
    dhfr_cells = probe_cell_kwargs(dhfr, cutoff_upper=ET_ARGS["cutoff_upper"])
    stmv_cells = probe_cell_kwargs(stmv, cutoff_upper=ET_ARGS["cutoff_upper"])
    model.energy_and_forces(dhfr, nbl=model.neighbors(dhfr, **dhfr_cells))
    ms = []
    for _ in range(EP_REPEATS):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y1, f1 = model.energy_and_forces(dhfr, nbl=model.neighbors(dhfr, **dhfr_cells))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    one_launches = _launches(em)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ys, fs = model.energy_and_forces(stmv, nbl=model.neighbors(stmv, **stmv_cells))
    torch.cuda.synchronize()
    stmv_ms = 1e3 * (time.perf_counter() - t0)
    stmv_peak = torch.cuda.max_memory_allocated() - base
    ys, fs = ys.cpu(), fs.cpu()
    torch.cuda.empty_cache()
    md_model = create_model(ET_ARGS, seed=SEED)
    md_model.module.std = EP_MD_STD
    sim = Simulation(md_model, dhfr, **EP_MD_ARGS)
    sim.set_velocities_from_temperature(EP_MD_ARGS["temperature_K"], seed=SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sim.step(EP_MD_STEPS)
    torch.cuda.synchronize()
    md_ms = 1e3 * (time.perf_counter() - t0) / EP_MD_STEPS
    md_pos, md_stale = state.pos.cpu(), bool(state.stale)
    md_moved = float((md_pos - dhfr.pos.cpu()).abs().max())
    del sim, state, md_model
    torch.cuda.empty_cache()
    # the kernels at the ranks' shapes, and which ops round a rank's rows
    # otherwise than those rows of the one-process call
    dhfr_nbl = model.neighbors(dhfr, **dhfr_cells)
    shard_shapes, shard_text = check_shard_kernels(dhfr, dhfr_nbl)
    probe_dhfr = row_count_probe(model, dhfr, dhfr_nbl)
    del dhfr_nbl
    stmv_nbl = model.neighbors(stmv, **stmv_cells)
    probe_stmv = row_count_probe(model, stmv, stmv_nbl)
    del stmv_nbl
    torch.cuda.empty_cache()
    # unscaled MD: one process's trajectory, and a one-process Simulation
    # whose lists and forces are held against each partitioned evaluation
    raw_model = create_model(ET_ARGS, seed=SEED)
    raw = Simulation(raw_model, dhfr, **EP_MD_ARGS)
    raw.set_velocities_from_temperature(EP_MD_ARGS["temperature_K"], seed=SEED + 1)
    raw_pos = raw.step(EP_MD_STEPS).pos.cpu()
    md = dict(EP_MD_ARGS, steps=EP_MD_STEPS, velocity_seed=SEED + 1)
    outs = _ranks(workdir, [_spec_case("dhfr", "forces", dhfr, repeat=EP_REPEATS, boundary_capacity=EP_BOUNDARY),
                            _spec_case("md", "md", dhfr, md=md, std=EP_MD_STD),
                            _spec_case("md_raw", "md", dhfr, md=md, record=True),
                            _spec_case("stmv", "forces", stmv, repeat=1, boundary_capacity=EP_BOUNDARY)],
                  "edge_partition", EP_TIMEOUT_S)
    if any(o["backend"] != "gloo" or o["size"] != 2 for o in outs):
        raise AssertionError(f"G-EP: expected two gloo ranks, got {[(o['backend'], o['size']) for o in outs]}")
    y1, f1 = y1.cpu(), f1.cpu()
    lines, launches = [], {}
    layers = ET_ARGS["num_layers"]
    for o in outs:
        d = o["cases"]["dhfr"]
        e_err = float((d["energy"] - y1).abs().max() / y1.abs().max())
        f_err = float((d["forces"] - f1).abs().max() / f1.abs().max())
        if e_err > EP_ENERGY_RTOL or f_err > EP_FORCE_TOL or not d["repeat_bitwise"]:
            raise AssertionError(f"G-EP rank {o['rank']}: energy {e_err:.3e}, forces {f_err:.3e}, repeat bitwise "
                                 f"{d['repeat_bitwise']}")
        want = {"et_message_fwd": layers, "et_message_bwd": layers, "et_message_bwd_src": layers, "select_topk": 0}
        if d["launches"] != want:
            raise AssertionError(f"G-EP rank {o['rank']}: launches {d['launches']}, expected {want} a call")
        st = d["stats"]
        if (st["n_local"], st["ghost_rows"]) != shard_shapes[o["rank"]][:2]:
            raise AssertionError(f"G-EP rank {o['rank']}: {st['n_local']} rows + {st['ghost_rows']} ghost rows, but "
                                 f"the kernel check's plan has {shard_shapes[o['rank']]}")
        lines.append(f"rank {o['rank']}: {st['n_local']} rows + {st['ghost_rows']} ghost rows "
                     f"({st['bytes_received']} B of fused source rows a gather), boundary edges {st['edges_boundary']} "
                     f"of {st['edges_total']} ({100 * st['boundary_fraction']:.1f} %), launches {d['launches']} a call, "
                     f"{statistics.median(d['ms']):.3f} ms a call (median of {EP_REPEATS}; build "
                     f"{d['build_ms']:.1f} ms), peak {d['peak_bytes'] / 2 ** 30:.3f} GiB, |dE|/|E| {e_err:.3e} "
                     f"max|dF|/max|F| {f_err:.3e}, forces bitwise one process's: {bool(torch.equal(d['forces'], f1))}")
        if o["rank"] == 0:
            launches["ep_dhfr"] = dict(d["launches"])
    log(f"edge-partitioned ET at DHFR (G-EP; {ET_ARGS['num_layers']}x{ET_ARGS['embedding_dimension']} fused bf16, K "
        f"{ET_ARGS['max_num_neighbors']}, {dhfr.num_atoms} atoms spatially sorted, 2 gloo ranks on one card; tol "
        f"{EP_ENERGY_RTOL} / {EP_FORCE_TOL}): one process {statistics.median(ms):.3f} ms a call, launches "
        f"{one_launches}; " + "; ".join(lines) + f"; repeats bitwise on every rank; {shard_text}; ops of the "
        f"one-process call rerun on rank 0's rows alone: at DHFR {_probe_text(probe_dhfr)}; at STMV "
        f"{_probe_text(probe_stmv)}")
    parts = []
    for o in outs:
        d = o["cases"]["stmv"]
        e_err = float((d["energy"] - ys).abs().max() / ys.abs().max())
        f_err = float((d["forces"] - fs).abs().max() / fs.abs().max())
        if e_err > EP_ENERGY_RTOL or f_err > EP_FORCE_TOL:
            raise AssertionError(f"G-EP STMV rank {o['rank']}: energy {e_err:.3e}, forces {f_err:.3e}")
        st = d["stats"]
        parts.append(f"rank {o['rank']}: peak {d['peak_bytes'] / 2 ** 30:.3f} GiB ({100 * d['peak_bytes'] / stmv_peak:.1f} "
                     f"% of one process's), {st['n_local']} rows + {st['ghost_rows']} ghost rows, boundary edges "
                     f"{st['edges_boundary']} of {st['edges_total']}, {d['ms'][0]:.1f} ms a call, |dE|/|E| {e_err:.3e} "
                     f"max|dF|/max|F| {f_err:.3e}")
    log(f"edge-partitioned ET at STMV (G-EP; {stmv.num_atoms} atoms, K {ET_ARGS['max_num_neighbors']}): one process's "
        f"energy+forces call takes {stmv_ms:.1f} ms (the first at this shape) and peaks at "
        f"{stmv_peak / 2 ** 30:.3f} GiB above its resident tensors (ET STMV MD, K 113: "
        f"{STMV_SINGLE_PEAK_GIB} GiB); " + "; ".join(parts))
    parts = []
    for o in outs:
        m = o["cases"]["md"]
        gap = float((m["pos"] - md_pos).abs().max())
        if m["stale"] or md_stale or not np.isfinite(m["pos"].numpy()).all() or gap > EP_MD_POS_TOL:
            raise AssertionError(f"G-MD rank {o['rank']}: stale {m['stale']} (one process {md_stale}), position gap "
                                 f"{gap:.3e} A")
        # the global skin list is built at every rebuild on every rank (a cell-list build: #6 once)
        want = {"et_message_fwd": layers * (EP_MD_STEPS + 1), "et_message_bwd": layers * (EP_MD_STEPS + 1),
                "et_message_bwd_src": layers * (EP_MD_STEPS + 1),
                "select_topk": -(-EP_MD_STEPS // EP_MD_ARGS["rebuild_every"])}
        if m["launches"] != want:
            raise AssertionError(f"G-MD rank {o['rank']}: launches {m['launches']}, expected {want}")
        # unscaled: each partitioned evaluation against one process's on the
        # same list (built at the same positions) at the same positions
        r = o["cases"]["md_raw"]
        f_gaps = []
        with torch.no_grad():
            for built_at, at, f_ranks in r["records"]:
                nbl = raw._build_nbl(built_at.to("cuda")).refine(at.to("cuda"), raw._lo, raw._hi, raw.box)
                f_one = raw._forces(at.to("cuda"), nbl)[1].cpu()
                f_gaps.append(float((f_ranks - f_one).abs().max() / f_one.abs().max()))
        raw_gap = float((r["pos"] - raw_pos).abs().max())
        if len(f_gaps) != EP_MD_STEPS + 1 or max(f_gaps) > EP_FUSED_FORCE_TOL or not np.isfinite(r["pos"].numpy()).all():
            raise AssertionError(f"G-MD rank {o['rank']} unscaled: {len(f_gaps)} evaluations, force gaps {f_gaps}")
        parts.append(f"rank {o['rank']}: {m['ms_per_step']:.3f} ms a step, position gap {gap:.3e} A, stale "
                     f"{m['stale']}, peak {m['peak_bytes'] / 2 ** 30:.3f} GiB; unscaled: max|dF|/max|F| of its "
                     f"{len(f_gaps)} evaluations against one process's on the same list and positions: largest "
                     f"{max(f_gaps):.3e}, first {f_gaps[0]:.3e}, last {f_gaps[-1]:.3e} (tol {EP_FUSED_FORCE_TOL}); "
                     f"positions after {EP_MD_STEPS} steps {raw_gap:.3e} A from one process's unscaled run, "
                     f"stale {r['stale']}")
        if o["rank"] == 0:
            launches["ep_md_dhfr"] = dict(m["launches"])
    log(f"edge-partitioned MD at DHFR (G-MD; Simulation(mesh, edge_partition=True), skin "
        f"{EP_MD_ARGS['neighbor_skin']} A, a rebuild every {EP_MD_ARGS['rebuild_every']} steps, Langevin "
        f"{EP_MD_ARGS['temperature_K']} K, {EP_MD_STEPS} steps, the trajectory with the output scaled by "
        f"{EP_MD_STD}; tol {EP_MD_POS_TOL} "
        f"A): one process {md_ms:.3f} ms a step, stale {md_stale}, atoms moved up to {md_moved:.3f} A; "
        + "; ".join(parts))
    probe = _ranks(workdir, [dict(name="probe", kind="probe", args=ET_ARGS, seed=SEED)], "probe", 120)
    results = probe[0]["cases"]["probe"]
    log("gloo collectives on CUDA tensors without host staging (2 ranks, one card; the port stages every one): "
        + json.dumps(results))
    return launches


# --- the parallel layer: edge-partitioned force training

# DHFR-size frames of one molecule (train, val, test; batches of one frame):
# the synthetic DHFR system with every atom displaced by EPT_NOISE A (seeded),
# labelled by a seeded ET_ARGS model
EPT_FRAMES = (4, 1, 1)
EPT_NOISE = 0.05
EPT_EPOCHS = 2
EPT_LR = 1e-4
# the Transformer's, TensorNet's and the composable ET's few steps: two
# frames, two epochs
EPT_TRAIN = dict(batch_size=1, inference_batch_size=1, num_epochs=2, train_size=2, val_size=1, test_size=1,
                 seed=SEED, lr=EPT_LR, lr_warmup_steps=0, save_interval=100, test_interval=-1, num_workers=0,
                 y_weight=1.0, neg_dy_weight=1.0, edge_boundary_limit=EP_BOUNDARY)
EPT_TIMEOUT_S = 600
# the composable f32 ET's depth (its per-edge f32 tensors of six layers'
# second order would fill much of the card twice over: two ranks and one process)
EPT_F32_LAYERS = 2
# Partitioned against one process, each tensor's largest gap over its
# largest value: the weights the fused kernels read as bf16 copies (the
# distance filters, TensorNet's edge MLP: each rank's share of their
# gradient is rounded to bf16 before the ranks' sum), the rest of the fused
# paths' gradients, the composable f32 paths'; and the logged metrics'
# largest relative gap.  Sound runs (NVIDIA H100 80GB HBM3, 700 W): copies
# 3.8e-3 to 5.6e-3; the rest 2.7e-5 for ET through the CLI (cuBLAS's
# row-count rounding of a rank's rows, 5.2e-5 on ET's DHFR forces, flips
# bf16 roundings in the kernels' operands), 5.4e-7 at most for T and
# TensorNet (their DHFR forces within 6.1e-7: no 128 -> 384 projection);
# metrics 1.4e-4 fused, 4.5e-7 f32; f32 gradients 5.0e-7.  Planted faults
# (the CPU tests' shapes, tests/test_torch_edge_partition.py): the rest of
# the gradients 2.9e-4 to 7.6e-3 (ghost hs4, w' or Z rows dropped), 1.2e-3
# to 1.0 composable (the exchange's transpose left constant, the energy
# loss through every rank's partials); metrics 1.0 (the force loss over a
# rank's own atoms).  Limits between:
EPT_BF16_COPY_TOL = 2 ** -6
EPT_BF16_GRAD_TOL = 1e-4
EPT_BF16_LOSS_RTOL = 1e-3
EPT_F32_GRAD_TOL = 1e-5
EPT_F32_LOSS_RTOL = 1e-5
EPT_COPIES = ("dk_proj", "dv_proj", "linears_scalar")


def _dhfr_frames(root):
    """EPT_FRAMES's frames, written as Custom's npy files under
    ``<root>/custom``: (the CLI's Custom flags, the same frames as an
    ``InMemoryArrays`` dataset, the first frame as a sorted padded batch on
    the card and its (y, neg_dy) labels in that order)."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort
    from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS, synthetic_system
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    z, pos = synthetic_system(DHFR_ATOMS, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    frames = sum(EPT_FRAMES)
    coords = np.stack([pos + EPT_NOISE * rng.standard_normal(pos.shape) for _ in range(frames)]).astype(np.float32)
    labeller = create_model(ET_ARGS, seed=SEED + 1)
    pad = -(-DHFR_ATOMS // 32) * 32
    energies, forces = [], []
    for c in coords:
        b = pad_molecules([{"z": z, "pos": c}], num_atoms=pad, device="cuda")
        y, f = labeller.energy_and_forces(b, nbl=labeller.neighbors(
            b, **probe_cell_kwargs(b, cutoff_upper=ET_ARGS["cutoff_upper"])))
        energies.append(float(y[0, 0]))
        forces.append(f[:DHFR_ATOMS].cpu().numpy())
    del labeller
    energies = np.asarray(energies, dtype=np.float32)[:, None]
    forces = np.stack(forces).astype(np.float32)
    custom = os.path.join(root, "custom")
    os.makedirs(custom)
    for name, value in (("coord", coords), ("embed", z.astype(np.int64)), ("energy", energies), ("force", forces)):
        np.save(os.path.join(custom, f"{name}_0.npy"), value)
    flags = ["--dataset", "Custom"] + [x for name in ("coord", "embed", "energy", "force")
                                       for x in (f"--{name}-files", os.path.join(custom, f"{name}_*.npy"))]
    data = InMemoryArrays(z=np.tile(z, frames).astype(np.int64), pos=coords.reshape(-1, 3),
                          offsets=np.arange(frames + 1) * DHFR_ATOMS, y=energies, neg_dy=forces.reshape(-1, 3))
    first = pad_molecules([{"z": z, "pos": coords[0], "neg_dy": forces[0]}], num_atoms=pad, device="cuda")
    first, _ = spatial_sort(first, cell=ET_ARGS["cutoff_upper"])
    targets = (torch.tensor(energies[:1]), first.neg_dy.cpu())
    return flags, data, first, targets


def _ept_flags(custom):
    """The CLI flags of G-EPT: ET_ARGS through the reference's flags, on the
    Custom frames."""
    a = ET_ARGS
    train, val, test = EPT_FRAMES

    def flags_of(root, log_dir):
        return [
            "--model", a["model"], "--embedding-dimension", str(a["embedding_dimension"]),
            "--num-layers", str(a["num_layers"]), "--num-heads", str(a["num_heads"]), "--num-rbf", str(a["num_rbf"]),
            "--rbf-type", a["rbf_type"], "--trainable-rbf", "true", "--neighbor-embedding", "true",
            "--distance-influence", a["distance_influence"], "--cutoff-upper", str(a["cutoff_upper"]),
            "--max-z", str(a["max_z"]), "--max-num-neighbors", str(a["max_num_neighbors"]), "--reduce-op", "add",
            "--derivative", "true", "--bf16-messages", "true", "--fused-attention", "true", *custom,
            "--batch-size", "1", "--inference-batch-size", "1", "--num-epochs", str(EPT_EPOCHS),
            "--train-size", str(train), "--val-size", str(val), "--test-size", str(test), "--lr", str(EPT_LR),
            "--seed", str(SEED), "--save-interval", "1", "--num-workers", "0", "--log-dir", log_dir,
            "--edge-boundary-limit", str(EP_BOUNDARY),
        ]

    return flags_of


def _ranks_said(text, what):
    """{rank: parsed value} of the ``_RANK_DRIVER`` lines "rank WHAT: RANK VALUE"."""
    out = {}
    for line in text.splitlines():
        if line.startswith(f"rank {what}: "):
            rank, value = line[len(f"rank {what}: "):].split(" ", 1)
            out[int(rank)] = json.loads(value)
    return out


def _step_ms(fit):
    """ms a step of a CLI "fit:" line."""
    return float(fit.split("(")[1].split(" ms")[0])


def _copies_gap(a, b, tol_copies, tol_rest):
    """(gap over the bf16-copied weights, gap over the rest, passed)."""
    copies = [k for k in b if any(c in k for c in EPT_COPIES)]
    rest = [k for k in b if k not in copies]
    gc = _grad_gap(a, b, copies) if copies else 0.0
    gr = _grad_gap(a, b, rest)
    return gc, gr, gc <= tol_copies and gr <= tol_rest


class _RankTables:
    """Each rank's rows of an edge-partitioned call's tables, assembled from
    the global ones through the plans the ranks build (the exchange done by
    indexing): ``loc`` the rank's rows, ``src`` its rows then its ghost
    sources, ``rx`` its rows then its ghost receivers (a per-slot table
    flat (N*K, ...) or (N, K, ...) takes whole receiver rows)."""

    def __init__(self, nbl, ranks=2):
        import torch

        from torchmdnet_tpu_torch.parallel.edge_partition import make_ring_plan
        from torchmdnet_tpu_torch.parallel.mesh import Mesh

        self.n, self.kk = nbl.idx.shape
        self.idx = nbl.idx
        nl = self.nl = self.n // ranks
        dev = nbl.idx.device
        self.plans = [make_ring_plan(nbl.idx, Mesh(size=ranks, rank=r, device=dev, backend="none"))
                      for r in range(ranks)]
        self.ids = []
        for r in range(ranks):
            rows = torch.arange(r * nl, (r + 1) * nl, device=dev)
            g_src = torch.cat([self.plans[o].src_send[r] + o * nl for o in range(ranks) if o != r])
            g_rx = torch.cat([self.plans[o].rx_send[r] + o * nl for o in range(ranks) if o != r])
            self.ids.append({"loc": rows, "src": torch.cat([rows, g_src]), "rx": torch.cat([rows, g_rx])})
        self.shapes = [(nl, int(i["src"].numel()) - nl, int(i["rx"].numel()) - nl) for i in self.ids]

    def take(self, r, t, which):
        if t is None:
            return None
        ids = self.ids[r][which]
        if t.shape[0] == self.n * self.kk:  # per slot, flat
            trail = tuple(t.shape[1:])
            return t.reshape((self.n, self.kk) + trail)[ids].reshape((-1,) + trail).contiguous()
        return t[ids].contiguous()

    def loc(self, r, t):
        return self.take(r, t, "loc")

    def src(self, r, t):
        return self.take(r, t, "src")

    def rx(self, r, t):
        return self.take(r, t, "rx")


def _rank_times(calls, bounds):
    """{kind: (ms, bound_ms, bound_by)} of rank 0's calls (CUDA events,
    median of 20, L2 flushed), each beside its bound at the rank's shape."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    return {kind: (event_ms(fn, flush=flush),) + bounds(kind) for kind, fn in calls.items()}


def _times_text(times):
    return ", ".join(f"{k} {ms:.4f} ms (bound {b:.4f} by {by})" for k, (ms, b, by) in times.items())


def _same_rows(tabs, r, got, whole):
    """Whether each of ``got`` equals the rank's rows of ``whole`` bitwise."""
    import torch

    return all(torch.equal(a, tabs.loc(r, b)) for a, b in zip(got, whole) if a is not None)


def _pass_rel(got, want):
    return max(_rel(a, b) for a, b in zip(got, want) if a is not None)


def check_shard_et_bwd2(batch, nbl):
    """#3's wrappers at each rank's shapes of a partitioned DHFR call
    (``ext=True``: the receiver pass over source tables and Z extended with
    the ghost rows, the source pass over the ghost receivers' rows, Z and
    hs4), against their plain versions on the same inputs and against those
    rows of the one-process call (bitwise expected).  Returns the log text."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    h, heads, rbf = ET_ARGS["embedding_dimension"], ET_ARGS["num_heads"], ET_ARGS["num_rbf"]
    _, t, ct = _kernel_inputs(None, nbl.idx.shape[1], h, rbf, ET_ARGS["cutoff_upper"], SEED + 5, batch=batch, nbl=nbl)
    kw = dict(heads=heads, act="silu", attn_act="silu")
    ins, z = [t[n] for n in ORDER], _z_like(t, SEED + 5)
    tabs = _RankTables(nbl)
    one = em.bwd2_receiver(nbl.idx, ins, ct, z, **kw)
    one_src = em.bwd2_source(nbl.idx, nbl.transpose_perm, ins, ct, z, one[7], **kw)

    def recv_outs(o):  # gq, gea, gcutm, gmsk, gdir0..2, gctx, gctvec, hs4
        return [o[0], o[1], o[2], o[3], *o[4], o[5], o[6], o[7]]

    src_at = {1, 2, 3, 4, 5}  # k, v, vec0..2: extended with the ghost sources
    rel, same = {}, {}
    for r in range(2):
        # the filters (12-15) are whole on every rank
        pick = lambda i, x: x if i >= 12 else (tabs.src(r, x) if i in src_at else tabs.loc(r, x))  # noqa: E731
        ins_r, z_r = [pick(i, x) for i, x in enumerate(ins)], [pick(i, x) for i, x in enumerate(z)]
        ct_r = tuple(tabs.loc(r, c) for c in ct)
        lidx = tabs.plans[r].lidx
        got = em.bwd2_receiver(lidx, ins_r, ct_r, z_r, ext=True, **kw)
        want = em.bwd2_receiver_reference(lidx, ins_r, ct_r, z_r, **kw)
        rel[f"recv2_rank{r}"] = _pass_rel(recv_outs(got), recv_outs(want))
        same[f"recv2_rank{r}"] = _same_rows(tabs, r, recv_outs(got), recv_outs(one))
        take = lambda i, x: x if i >= 12 else (tabs.src(r, x) if i in src_at else tabs.rx(r, x))  # noqa: E731
        ins_x, z_x = [take(i, x) for i, x in enumerate(ins)], [take(i, x) for i, x in enumerate(z)]
        ins_x[7] = ins_x[8]  # the source pass reads no cutm: msk stands in for its shape
        ct_x = tuple(tabs.rx(r, c) for c in ct)
        hs4 = tabs.rx(r, one[7])
        got = em.bwd2_source(lidx, tabs.plans[r].perm_rx, ins_x, ct_x, z_x, hs4, ext=True, **kw)
        want = em.bwd2_source_reference(lidx, tabs.plans[r].perm_rx, ins_x, ct_x, z_x, hs4, heads=heads, act="silu")
        rel[f"src2_rank{r}"] = _pass_rel(got, want)
        same[f"src2_rank{r}"] = _same_rows(tabs, r, got, one_src)
    torch.cuda.synchronize()
    times = _et_rank_times(tabs, ins, z, ct, kw, rbf)
    text = (f"#3's wrappers at each rank's shapes ({_shape_text(tabs)}) against their plain versions (tol "
            f"{PART_TOL}): {_fmt(rel)}; bitwise those rows of the one-process call: {json.dumps(same)}; rank 0's "
            f"ET kernels timed at its shape: {_times_text(times)}")
    if max(rel.values()) > PART_TOL:
        raise AssertionError(f"G-EPT: #3 disagrees with its plain version at the partitioned shapes: {text}")
    return text, times


def _et_rank_times(tabs, ins, z, ct, kw, rbf):
    """#1, #2 (with the weights' cotangents) and #3 (each pass and its weight
    reduction) as a force-loss step runs them on rank 0's rows."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    r, src_at = 0, {1, 2, 3, 4, 5}
    lidx, perm_rx = tabs.plans[r].lidx, tabs.plans[r].perm_rx
    pick = lambda i, x: x if i >= 12 else (tabs.src(r, x) if i in src_at else tabs.loc(r, x))  # noqa: E731
    take = lambda i, x: x if i >= 12 else (tabs.src(r, x) if i in src_at else tabs.rx(r, x))  # noqa: E731
    ins_r, z_r = [pick(i, x) for i, x in enumerate(ins)], [pick(i, x) for i, x in enumerate(z)]
    ins_x, z_x = [take(i, x) for i, x in enumerate(ins)], [take(i, x) for i, x in enumerate(z)]
    ins_x[7] = ins_x[8]
    ct_r, ct_x = tuple(tabs.loc(r, c) for c in ct), tuple(tabs.rx(r, c) for c in ct)
    dirs_r, dirs_x = tuple(ins_r[9:12]), tuple(ins_x[9:12])
    one_hs = em.bwd_receiver(tabs.idx, *ins[:9], tuple(ins[9:12]), *ins[12:], *ct, want_dpre=False, **kw)[4]
    one_hs4 = em.bwd2_receiver(tabs.idx, ins, ct, z, **kw)[7]
    hs_x, hs4_x = tabs.rx(r, one_hs), tabs.rx(r, one_hs4)
    ea2 = ins_r[6].reshape(-1, rbf)
    zea2 = z_r[6].reshape(-1, rbf)

    def bwd():
        rk = em.bwd_receiver(lidx, *ins_r[:9], dirs_r, *ins_r[12:], *ct_r, want_dpre=True, ext=True, **kw)
        em.bwd_source(lidx, perm_rx, *ins_x[:9], dirs_x, *ins_x[12:], *ct_x, hs_x, ext=True, **kw)
        em.weight_grads([(ea2, rk[5])], rbf)

    def bwd2():
        rk = em.bwd2_receiver(lidx, ins_r, ct_r, z_r, ext=True, **kw)
        em.bwd2_source(lidx, perm_rx, ins_x, ct_x, z_x, hs4_x, ext=True, **kw)
        em.weight_grads([(ea2, rk[8]), (zea2, rk[9])], rbf)

    calls = {"fwd": lambda: em.run_fwd(lidx, *ins_r[:9], dirs_r, *ins_r[12:], ext=True, **kw), "bwd_w": bwd,
             "bwd2": bwd2}
    h = ins[0].shape[1]
    return _rank_times(calls, lambda kind: _bounds(tabs.nl, tabs.kk, h, rbf, kind))


def _shape_text(tabs):
    return f"N={tabs.n} K={tabs.kk}: " + ", ".join(
        f"rank {r} {a} rows, {b} ghost source rows, {c} ghost receivers" for r, (a, b, c) in enumerate(tabs.shapes))


def check_shard_t(batch, nbl):
    """The Transformer's #11, #12 and #13 wrappers at each rank's shapes of a
    partitioned DHFR call (``ext=True``), each pass against its plain version
    on the same inputs and against those rows of the one-process call.
    Returns the log text."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    a = T_ARGS
    h, heads, rbf = a["embedding_dimension"], a["num_heads"], a["num_rbf"]
    _, t, ct = _t_kernel_inputs(None, nbl.idx.shape[1], h, rbf, a["cutoff_upper"], SEED + 6, batch=batch, nbl=nbl)
    kw = dict(heads=heads, act="silu", attn_act="silu")
    ins, z = [t[n] for n in T_ORDER], _t_z_like(t, SEED + 6)
    idx, perm = nbl.idx, nbl.transpose_perm
    tabs = _RankTables(nbl)
    one_fwd = tmk.run_fwd(idx, *ins, **kw)
    one_recv = tmk.bwd_receiver(idx, *ins, ct, want_dpre=False, **kw)
    one_src = tmk.bwd_source(idx, perm, *ins, ct, one_recv[3], **kw)
    one_recv2 = tmk.bwd2_receiver(idx, ins, ct, z, **kw)
    one_src2 = tmk.bwd2_source(idx, perm, ins, ct, z, one_recv2[4], **kw)
    src_at = {1, 2}
    rel, same = {}, {}
    for r in range(2):
        lidx, perm_rx = tabs.plans[r].lidx, tabs.plans[r].perm_rx
        pick = lambda i, x: x if i >= 5 else (tabs.src(r, x) if i in src_at else tabs.loc(r, x))  # noqa: E731
        take = lambda i, x: x if i >= 5 else (tabs.src(r, x) if i in src_at else tabs.rx(r, x))  # noqa: E731
        ins_r, z_r = [pick(i, x) for i, x in enumerate(ins)], [pick(i, x) for i, x in enumerate(z)]
        ins_x, z_x = [take(i, x) for i, x in enumerate(ins)], [take(i, x) for i, x in enumerate(z)]
        ct_r, ct_x = tabs.loc(r, ct), tabs.rx(r, ct)
        got = tmk.run_fwd(lidx, *ins_r, ext=True, **kw)
        with torch.no_grad():
            want = tmk.t_messages_reference(lidx, *ins_r, perm=perm_rx, **kw)
        rel[f"fwd_rank{r}"], same[f"fwd_rank{r}"] = _rel(got, want), _same_rows(tabs, r, [got], [one_fwd])
        got = tmk.bwd_receiver(lidx, *ins_r, ct_r, want_dpre=False, ext=True, **kw)[:4]
        want = tmk.bwd_receiver_reference(lidx, *ins_r, ct_r, want_dpre=False, **kw)[:4]
        rel[f"recv_rank{r}"], same[f"recv_rank{r}"] = _pass_rel(got, want), _same_rows(tabs, r, got, one_recv[:4])
        hs = tabs.rx(r, one_recv[3])
        got = tmk.bwd_source(lidx, perm_rx, *ins_x, ct_x, hs, ext=True, **kw)
        want = tmk.bwd_source_reference(lidx, perm_rx, ins_x[0], ins_x[3], *ins_x[5:], ct_x, hs, heads=heads,
                                        act="silu")
        rel[f"src_rank{r}"], same[f"src_rank{r}"] = _pass_rel(got, want), _same_rows(tabs, r, got, one_src)
        got = tmk.bwd2_receiver(lidx, ins_r, ct_r, z_r, ext=True, **kw)[:5]
        want = tmk.bwd2_receiver_reference(lidx, ins_r, ct_r, z_r, **kw)[:5]
        rel[f"recv2_rank{r}"], same[f"recv2_rank{r}"] = _pass_rel(got, want), _same_rows(tabs, r, got, one_recv2[:5])
        hs4 = tabs.rx(r, one_recv2[4])
        got = tmk.bwd2_source(lidx, perm_rx, ins_x, ct_x, z_x, hs4, ext=True, **kw)
        want = tmk.bwd2_source_reference(lidx, perm_rx, ins_x, ct_x, z_x, hs4, heads=heads, act="silu")
        rel[f"src2_rank{r}"], same[f"src2_rank{r}"] = _pass_rel(got, want), _same_rows(tabs, r, got, one_src2)
    torch.cuda.synchronize()
    times = _t_rank_times(tabs, ins, z, ct, kw, one_recv[3], one_recv2[4])
    text = (f"#11/#12/#13's wrappers at each rank's shapes ({_shape_text(tabs)}) against their plain versions (tol "
            f"fwd {FWD_TOL}, passes {PART_TOL}): {_fmt(rel)}; bitwise those rows of the one-process call: "
            f"{json.dumps(same)}; rank 0's Transformer kernels timed at its shape: {_times_text(times)}")
    bad = [k for k, v in rel.items() if v > (FWD_TOL if k.startswith("fwd") else PART_TOL)]
    if bad:
        raise AssertionError(f"G-EPT: a Transformer kernel disagrees with its plain version at the partitioned "
                             f"shapes: {text}")
    return text, times


def _t_rank_times(tabs, ins, z, ct, kw, one_hs, one_hs4):
    """#11, #12 (frozen, as serving runs it, and with the weights'
    cotangents) and #13 on rank 0's rows, each with its source pass and
    weight reduction."""
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    r = 0
    lidx, perm_rx = tabs.plans[r].lidx, tabs.plans[r].perm_rx
    pick = lambda i, x: x if i >= 5 else (tabs.src(r, x) if i in (1, 2) else tabs.loc(r, x))  # noqa: E731
    take = lambda i, x: x if i >= 5 else (tabs.src(r, x) if i in (1, 2) else tabs.rx(r, x))  # noqa: E731
    ins_r, z_r = [pick(i, x) for i, x in enumerate(ins)], [pick(i, x) for i, x in enumerate(z)]
    ins_x, z_x = [take(i, x) for i, x in enumerate(ins)], [take(i, x) for i, x in enumerate(z)]
    ct_r, ct_x = tabs.loc(r, ct), tabs.rx(r, ct)
    hs_x, hs4_x = tabs.rx(r, one_hs), tabs.rx(r, one_hs4)
    rbf = ins[3].shape[-1]
    ea2, zea2 = ins_r[3].reshape(-1, rbf), z_r[3].reshape(-1, rbf)

    def bwd(want):
        rk = tmk.bwd_receiver(lidx, *ins_r, ct_r, want_dpre=want, ext=True, **kw)
        tmk.bwd_source(lidx, perm_rx, *ins_x, ct_x, hs_x, ext=True, **kw)
        if want:
            em.weight_grads([(ea2, rk[4])], rbf)

    def bwd2():
        rk = tmk.bwd2_receiver(lidx, ins_r, ct_r, z_r, ext=True, **kw)
        tmk.bwd2_source(lidx, perm_rx, ins_x, ct_x, z_x, hs4_x, ext=True, **kw)
        em.weight_grads([(ea2, rk[5]), (zea2, rk[6])], rbf)

    calls = {"fwd": lambda: tmk.run_fwd(lidx, *ins_r, ext=True, **kw), "bwd": lambda: bwd(False),
             "bwd_w": lambda: bwd(True), "bwd2": bwd2}
    h = ins[0].shape[1]
    return _rank_times(calls, lambda kind: _t_bounds(tabs.nl, tabs.kk, h, rbf, kind))


def check_shard_tn(batch, nbl):
    """TensorNet's #8, #9 and #10 wrappers at each rank's shapes of a
    partitioned DHFR call (``ext=True``: cat, ct and Z's cat extended with
    the ghost sources; the source-row sum over the ghost receivers' ct rows
    and w' slots), against their plain versions on the same inputs and
    against those rows of the one-process call.  Returns the log text."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    a = TN_ARGS
    h, rbf = a["embedding_dimension"], a["num_rbf"]
    ins_d, ct = _tn_kernel_inputs(nbl, batch.pos, h, rbf, a["cutoff_upper"], SEED + 7)
    ins, z = [ins_d[n] for n in TN_ORDER], _tn_z_like(ins_d, SEED + 7)
    idx, perm = nbl.idx, nbl.transpose_perm
    n, kk = idx.shape
    tabs = _RankTables(nbl)
    one_fwd = tm.run_fwd(idx, *ins, act="silu")
    one_bwd = tm.bwd_rows(idx, *ins, ct, act="silu", want_rows=False)[:3]
    one_e = tm.bwd2_edges(idx, ins, ct, z, act="silu")
    one_gcat = tm.src_sum(perm, ct, one_e[3], n, kk)
    rel, same = {}, {}
    for r in range(2):
        lidx, perm_rx = tabs.plans[r].lidx, tabs.plans[r].perm_rx
        ins_r = [tabs.src(r, ins[0]), tabs.loc(r, ins[1]), tabs.loc(r, ins[2]), *ins[3:]]
        z_r = [tabs.src(r, z[0]), tabs.loc(r, z[1]), tabs.loc(r, z[2]), *z[3:]]
        ct_s = tabs.src(r, ct)
        got = tm.run_fwd(lidx, *ins_r, act="silu", ext=True)
        with torch.no_grad():
            want = tm.tn_messages_reference(lidx, *ins_r, act="silu", perm=perm_rx)
        rel[f"fwd_rank{r}"], same[f"fwd_rank{r}"] = _rel(got, want), _same_rows(tabs, r, [got], [one_fwd])
        got = tm.bwd_rows(lidx, *ins_r, ct_s, act="silu", want_rows=False, ext=True)[:3]
        want = tm.bwd_reference(lidx, *ins_r, ct_s, act="silu", want_rows=False)[:3]
        rel[f"bwd_rank{r}"], same[f"bwd_rank{r}"] = _pass_rel(got, want), _same_rows(tabs, r, got, one_bwd)
        got = tm.bwd2_edges(lidx, ins_r, ct_s, z_r, act="silu", ext=True)[:4]
        want = tm.bwd2_edges_reference(lidx, ins_r, ct_s, z_r, act="silu")[:4]
        rel[f"bwd2_rank{r}"], same[f"bwd2_rank{r}"] = _pass_rel(got, want), _same_rows(tabs, r, got, one_e[:4])
        ct_x, wdot_x = tabs.rx(r, ct), tabs.rx(r, one_e[3])
        got = tm.src_sum(perm_rx, ct_x, wdot_x, tabs.nl, kk)
        want = tm.src_sum_reference(perm_rx, ct_x, wdot_x, tabs.nl, kk, torch.bfloat16)
        rel[f"src_sum_rank{r}"], same[f"src_sum_rank{r}"] = _rel(got, want), _same_rows(tabs, r, [got], [one_gcat])
    torch.cuda.synchronize()
    times = _tn_rank_times(tabs, ins, z, ct, one_e[3])
    tol = {"fwd": TN_FWD_TOL, "bwd": BWD_TOL, "bwd2": BWD2_TOL, "src": PART_TOL}
    text = (f"#8/#9/#10's wrappers at each rank's shapes ({_shape_text(tabs)}) against their plain versions (tol "
            f"{json.dumps(tol)}): {_fmt(rel)}; bitwise those rows of the one-process call: {json.dumps(same)}; "
            f"rank 0's TensorNet kernels timed at its shape: {_times_text(times)}")
    if any(v > tol[k.split("_")[0]] for k, v in rel.items()):
        raise AssertionError(f"G-EPT: a TensorNet kernel disagrees with its plain version at the partitioned "
                             f"shapes: {text}")
    return text, times


def _tn_rank_times(tabs, ins, z, ct, one_wdot):
    """#8, #9 (frozen, and with the weights' cotangents: its reduction) and
    #10 (edge kernel, source-row sum, reduction) on rank 0's rows."""
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    r = 0
    lidx, perm_rx = tabs.plans[r].lidx, tabs.plans[r].perm_rx
    ins_r = [tabs.src(r, ins[0]), tabs.loc(r, ins[1]), tabs.loc(r, ins[2]), *ins[3:]]
    z_r = [tabs.src(r, z[0]), tabs.loc(r, z[1]), tabs.loc(r, z[2]), *z[3:]]
    ct_s, ct_x, wdot_x = tabs.src(r, ct), tabs.rx(r, ct), tabs.rx(r, one_wdot)
    h, rbf = ins[0].shape[1] // 9, ins[1].shape[-1]

    def bwd2():
        e = tm.bwd2_edges(lidx, ins_r, ct_s, z_r, act="silu", ext=True)
        tm.src_sum(perm_rx, ct_x, wdot_x, tabs.nl, tabs.kk)
        tm.weight_grads(e[4], tm._bwd2_jobs(h, tm._rbfp(rbf)))

    calls = {"fwd": lambda: tm.run_fwd(lidx, *ins_r, act="silu", ext=True),
             "bwd": lambda: tm.run_bwd(lidx, *ins_r, ct_s, act="silu", want_weight_grads=False, ext=True),
             "bwd_w": lambda: tm.run_bwd(lidx, *ins_r, ct_s, act="silu", want_weight_grads=True, ext=True),
             "bwd2": bwd2}
    return _rank_times(calls, lambda kind: _tn_bounds(tabs.nl, tabs.kk, h, rbf, kind))


def _one_force_grads(args, batch, targets):
    """One process's energies, forces and force-loss gradient of a fresh
    model (seed SEED) on ``batch``, with the cell sizes the ranks probe."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
    from torchmdnet_tpu_torch.tools.partition_run import force_loss

    model = create_model(args, seed=SEED)
    nbl = model.neighbors(batch, **probe_cell_kwargs(batch, cutoff_upper=args["cutoff_upper"]))
    y, f = model.energy_and_forces(batch, nbl=nbl)
    y2, f2 = model.energy_and_forces(batch, nbl=nbl, create_graph=True)
    y_t, f_t = (x.to("cuda") for x in targets)
    force_loss(y2, f2, y_t, f_t, batch.atom_mask, float(batch.atom_mask.sum())).backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters() if p.requires_grad}
    torch.cuda.synchronize()
    return y.cpu(), f.cpu(), grads


def _one_train(h, data):
    """One process's plain ``Trainer.fit`` of a rank case: (metrics.csv rows,
    the first step's gradients, the same step's in force_grad_mode="jvp"
    (taken before it), seconds, steps)."""
    import csv

    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.train.trainer import Trainer

    from torchmdnet_tpu_torch.tools.partition_run import first_step_recorder

    h = dict(h, device="cuda")
    dm = DataModule(h, dataset=data)
    dm.setup()
    recording, grads, jvp_grads = first_step_recorder(Trainer, jvp=True)
    trainer = recording(create_model(h, seed=h["seed"]), h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(dm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(h["log_dir"], "metrics.csv")) as f:
        rows = [{k: float(v) for k, v in r.items() if v not in ("", None)} for r in csv.DictReader(f)]
    return rows, grads, jvp_grads, seconds, trainer.state.global_step


def _train_launches(layers, steps, evals, prefix, src=True, jvp_steps=0):
    """A training run's launches a rank: (fwd, bwd, bwd2) per layer per step
    (1, 2, 1), per evaluation batch (1, 1, 0) and per extra step in
    force_grad_mode="jvp" (3, 3, 0), with the source passes."""
    out = {f"{prefix}_fwd": layers * (steps + evals + 3 * jvp_steps),
           f"{prefix}_bwd": layers * (2 * steps + evals + 3 * jvp_steps), f"{prefix}_bwd2": layers * steps}
    if src:
        out[f"{prefix}_bwd_src"], out[f"{prefix}_bwd2_src"] = out[f"{prefix}_bwd"], out[f"{prefix}_bwd2"]
    return out


def edge_training(workdir):
    """(G-EPT) Edge-partitioned force training on two ranks of the one card
    (gloo), against one process on the same batches:

    - ET_ARGS fused bf16 through the CLI (``--edge-partition true --ndevices
      2``, each rank running ``_RANK_DRIVER``) on DHFR-size frames written as
      Custom npy files, against one CLI process: every logged metric, the
      first step's gradients, each rank's launches and peak memory, seconds a
      step;
    - the Transformer (T_ARGS) and TensorNet (TN_ARGS) fused: energy, forces
      and the force-loss gradient of the DHFR frame, and a few
      ``Trainer.fit`` steps, and ET composable f32's steps, through
      ``tools/partition_run.py``, against one process in this process;
    - #3, #8-#10 and #11-#13's wrappers at each rank's shapes against their
      plain versions.

    Returns ({path: launches} of rank 0, {kernel row: {path: (ms,
    bound_ms)}} at rank 0's shape)."""
    import torch

    root = os.path.join(workdir, "data")
    custom, frames, dhfr, targets = _dhfr_frames(root)
    flags_of = _ept_flags(custom)
    train, val, test = EPT_FRAMES
    steps, evals = EPT_EPOCHS * train, EPT_EPOCHS * val + test
    layers = ET_ARGS["num_layers"]
    lines, launches = [], {}
    # ET fused bf16 through the CLI: one process, then two ranks
    one, g1, (fit1, text1), s1 = _dp_run("ept_one", workdir, root, solo=True, flags_of=flags_of)
    two, g2, (fit2, text2), s2 = _dp_run("ept_ranks", workdir, root, extra=("--edge-partition", "true",
                                                                         "--ndevices", "2"),
                                         ranks=2, flags_of=flags_of)
    mode = [ln for ln in text2.splitlines() if ln.startswith("edge partition:")]
    if not mode or "2 ranks over the gloo backend" not in mode[0]:
        raise AssertionError(f"G-EPT: the two-rank run did not report its edge partition: {mode}")
    rank_launches, peaks = _ranks_said(text2, "launches"), _ranks_said(text2, "peak bytes")
    one_peak = _ranks_said(text1, "peak bytes")[0]
    want = _train_launches(layers, steps, evals, "et_message")
    got = {k: v for k, v in rank_launches[0].items() if k.startswith("et_message") and v}
    if set(rank_launches) != {0, 1} or any(
            {k: v for k, v in rl.items() if k.startswith("et_message") and v} != want for rl in rank_launches.values()):
        raise AssertionError(f"G-EPT: expected {want} launches on each rank, got {rank_launches}")
    launches["ep_train_et"] = got
    gc, gr, ok = _copies_gap(g1, g2, EPT_BF16_COPY_TOL, EPT_BF16_GRAD_TOL)
    loss_gap = _rows_gap(one, two)
    epochs = [r for r in one if "train_total_mse_loss" in r]
    lines.append(
        f"ET {layers}x{ET_ARGS['embedding_dimension']} fused bf16 through the CLI (Custom frames {EPT_FRAMES}, "
        f"{EPT_EPOCHS} epochs, {steps} steps): one process {s1:.1f} s [{fit1}], peak "
        f"{one_peak / 2 ** 30:.3f} GiB, epoch train losses {[round(r['train_total_mse_loss'], 4) for r in epochs]}; "
        f"--edge-partition true --ndevices 2 ({mode[0]}) {s2:.1f} s [{fit2}], ms a step one rank / one process "
        f"{_step_ms(fit2) / _step_ms(fit1):.2f}, peak rank 0 {peaks[0] / 2 ** 30:.3f} GiB, rank 1 "
        f"{peaks[1] / 2 ** 30:.3f} GiB; launches a rank {got}; logged metrics' largest gap {loss_gap[0]:.3e} "
        f"({loss_gap[1]}; tol {EPT_BF16_LOSS_RTOL}); first step's gradients: the bf16-copied filters {gc:.3e} "
        f"(tol {EPT_BF16_COPY_TOL}), the rest {gr:.3e} (tol {EPT_BF16_GRAD_TOL})")
    if not ok or loss_gap[0] > EPT_BF16_LOSS_RTOL:
        raise AssertionError(f"G-EPT: ET partitioned training disagrees with one process: {lines[-1]}")
    # the Transformer and TensorNet fused, ET composable f32: the ranks, then one process each
    et32 = dict(ET_ARGS, bf16_messages=False, fused_attention=False, num_layers=EPT_F32_LAYERS)
    import dataclasses

    fields = {f.name: getattr(dhfr, f.name) for f in dataclasses.fields(dhfr)}
    fields = {k: v.cpu() if hasattr(v, "cpu") else v for k, v in fields.items()}
    cases = []
    for name, args in (("t_dhfr", T_ARGS), ("tn_dhfr", TN_ARGS)):
        cases.append(dict(name=name, kind="forces", args=args, seed=SEED, batch=fields, repeat=2,
                          boundary_capacity=EP_BOUNDARY, targets=targets))
    train_cases = {"train_t": T_ARGS, "train_tn": TN_ARGS, "train_et_f32": et32}
    for name, args in train_cases.items():
        cases.append(dict(name=name, kind="train", hparams=dict(args, **EPT_TRAIN), dataset=frames,
                          log_dir=os.path.join(workdir, name), jvp_grads=True))
    outs = _ranks(workdir, cases, "edge_training", EPT_TIMEOUT_S)
    if any(o["backend"] != "gloo" or o["size"] != 2 for o in outs):
        raise AssertionError(f"G-EPT: expected two gloo ranks, got {[(o['backend'], o['size']) for o in outs]}")
    for name, args, prefix in (("t_dhfr", T_ARGS, "t_message"), ("tn_dhfr", TN_ARGS, "tn_message")):
        y1, f1, g_one = _one_force_grads(args, dhfr, targets)
        ly = args["num_layers"]
        want = {f"{prefix}_fwd": ly, f"{prefix}_bwd": ly}
        if prefix == "t_message":
            want[f"{prefix}_bwd_src"] = ly
        parts = []
        for o in outs:
            d = o["cases"][name]
            e_err = float((d["energy"] - y1).abs().max() / y1.abs().max())
            f_err = float((d["forces"] - f1).abs().max() / f1.abs().max())
            gc, gr, ok = _copies_gap(g_one, d["grads"], EPT_BF16_COPY_TOL, EPT_BF16_GRAD_TOL)
            got = {k: v for k, v in d["launches"].items() if k.startswith(prefix) and v}
            if e_err > EP_ENERGY_RTOL or f_err > EP_FORCE_TOL or not ok or got != want:
                raise AssertionError(f"G-EPT {name} rank {o['rank']}: energy {e_err:.3e}, forces {f_err:.3e}, "
                                     f"gradients {gc:.3e} / {gr:.3e}, launches {got} (expected {want})")
            st = d["stats"]
            parts.append(f"rank {o['rank']}: {st['n_local']} rows + {st['ghost_rows']} ghost rows, "
                         f"{statistics.median(d['ms']):.3f} ms a call, peak {d['peak_bytes'] / 2 ** 30:.3f} GiB, "
                         f"|dE|/|E| {e_err:.3e}, max|dF|/max|F| {f_err:.3e}, force-loss gradient: copies {gc:.3e}, "
                         f"rest {gr:.3e}, launches {got} a call, the gradient's {d['grad_launches']}")
            if o["rank"] == 0:
                launches[f"ep_{name}"] = got
        lines.append(f"{name} ({ly}x{args['embedding_dimension']} fused bf16, K {args['max_num_neighbors']}; tol "
                     f"{EP_ENERGY_RTOL} / {EP_FORCE_TOL}, gradients {EPT_BF16_COPY_TOL} / "
                     f"{EPT_BF16_GRAD_TOL}): " + "; ".join(parts))
    for name, args in train_cases.items():
        h = dict(args, **EPT_TRAIN, log_dir=os.path.join(workdir, name + "_one"))
        rows1, g_one, j_one, sec1, steps1 = _one_train(h, frames)
        d = outs[0]["cases"][name]
        fused = name != "train_et_f32"
        # the first step by gradgrad and, before it, the same step in jvp mode
        gaps = []
        for one, ranks in ((g_one, d["grads"]), (j_one, d["jvp_grads"])):
            if fused:
                gaps.append(_copies_gap(one, ranks, EPT_BF16_COPY_TOL, EPT_BF16_GRAD_TOL))
            else:
                gr = _grad_gap(one, ranks)
                gaps.append((0.0, gr, gr <= EPT_F32_GRAD_TOL))
        (gc, gr, ok), (jc, jr, jok) = gaps
        ok = ok and jok
        gap = _rows_gap(rows1, d["rows"])
        rtol = EPT_BF16_LOSS_RTOL if fused else EPT_F32_LOSS_RTOL
        prefix = {"train_t": "t_message", "train_tn": "tn_message", "train_et_f32": None}[name]
        tsteps = EPT_TRAIN["num_epochs"] * EPT_TRAIN["train_size"]
        tevals = EPT_TRAIN["num_epochs"] * EPT_TRAIN["val_size"]
        want = (_train_launches(args["num_layers"], tsteps, tevals, prefix, src=name == "train_t", jvp_steps=1)
                if prefix else {})
        got = {k: v for k, v in d["launches"].items() if prefix and k.startswith(prefix) and v}
        if not ok or gap[0] > rtol or d["steps"] != steps1 or got != want:
            raise AssertionError(f"G-EPT {name}: gradients {gc:.3e} / {gr:.3e}, jvp step {jc:.3e} / {jr:.3e}, "
                                 f"metrics {gap}, steps {d['steps']} / {steps1}, launches {got} (expected {want})")
        if prefix:
            launches[f"ep_{name}"] = got
        peak = [o["cases"][name]["peak_bytes"] / 2 ** 30 for o in outs]
        lines.append(f"{name} ({args['num_layers']}x{args['embedding_dimension']}, "
                     f"{'fused bf16' if fused else 'composable f32'}, {d['steps']} steps): one process "
                     f"{1e3 * sec1 / steps1:.1f} ms a step (validation included), rank 0 "
                     f"{1e3 * d['seconds'] / d['steps']:.1f} ms, peak ranks {peak[0]:.3f} / {peak[1]:.3f} GiB; "
                     f"metrics' largest gap {gap[0]:.3e} ({gap[1]}; tol {rtol}); first step's gradients "
                     + (f"copies {gc:.3e} (tol {EPT_BF16_COPY_TOL}), rest {gr:.3e} (tol {EPT_BF16_GRAD_TOL}); "
                        f"the same step in force_grad_mode jvp, ranks against one process: copies {jc:.3e}, "
                        f"rest {jr:.3e}" if fused else f"{gr:.3e} (tol {EPT_F32_GRAD_TOL}); in force_grad_mode "
                        f"jvp {jr:.3e}") + f"; launches a rank {got} (with the jvp step's)")
    torch.cuda.empty_cache()
    # the wrappers at the ranks' shapes of the DHFR frame's lists
    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    checks, times = [], {}
    for args, check, prefix in ((ET_ARGS, check_shard_et_bwd2, "et_message"), (T_ARGS, check_shard_t, "t_message"),
                                (TN_ARGS, check_shard_tn, "tn_message")):
        model = create_model(args, seed=SEED)
        nbl = model.neighbors(dhfr, **probe_cell_kwargs(dhfr, cutoff_upper=args["cutoff_upper"]))
        text, t = check(dhfr, nbl)
        checks.append(text)
        times[prefix] = t
    log("edge-partitioned force training (G-EPT; 2 gloo ranks on one card, each against one process on the "
        "same batches): " + "; ".join(lines) + "; " + "; ".join(checks))
    # (ms, bound) of each kernel row on the G-EPT paths, at rank 0's shape:
    # the serving calls run #2/#9/#12 frozen, the training steps with weights
    timed = {}
    for prefix, serve, train_path in (("et_message", None, "ep_train_et"), ("t_message", "ep_t_dhfr", "ep_train_t"),
                                      ("tn_message", "ep_tn_dhfr", "ep_train_tn")):
        t = times[prefix]
        timed.setdefault(f"{prefix}_fwd", {})[train_path] = t["fwd"][:2]
        timed.setdefault(f"{prefix}_bwd", {})[train_path] = t["bwd_w"][:2]
        timed.setdefault(f"{prefix}_bwd2", {})[train_path] = t["bwd2"][:2]
        if serve:
            timed[f"{prefix}_fwd"][serve] = t["fwd"][:2]
            timed[f"{prefix}_bwd"][serve] = t["bwd"][:2]
    return launches, timed


# --- slice H1: force_grad_mode="jvp", third derivatives, JAX checkpoints ------

# (H-FGM) One force-loss step's gradients in force_grad_mode="jvp" against
# the same step by grad-of-grad, from the same weights and batch, both
# fused bf16 at the training shapes, per parameter tensor as max|dg| /
# max|g| and over all parameters as |dg| / |g|: the two modes round the
# bf16 operands' cotangents and tangents at different points (the CPU
# tests' 24 atoms, 2 layers: at most 5.8e-3, the bf16-copied filters
# 8.4e-3).  Measured on an NVIDIA H100 80GB HBM3 at the training shapes: ET
# 6.5e-3 (|dg|/|g| 2.9e-4), the Transformer 5.2e-3 (4.0e-5), TensorNet
# 4.5e-3 (5.6e-7).  These limits are coarse: the energy loss's gradient
# dominates the step's (the force part was 0.18-0.34 % of it in the CPU
# tests), and the modes' bf16 roundings of it hide a fault of the force
# part.  So the force loss alone (y_weight 0: the gradient the jvp pass
# computes) is compared too, with a limit a family
# (FGM_FORCE_L2_TOL, |dg|/|g|) between the sound reading and the check's
# own planted fault, which every run repeats: the same jvp step with the
# fused backward's tangent dropped (``derivatives.vjp_tangent`` giving
# zeros, as a kernel's outputs carry no tangent), whose |dg|/|g| must
# exceed the limit.  Measured by this phase on an NVIDIA H100 80GB HBM3 at
# 700 W, sound against fault: ET 1.964e-3 against 0.591, T 5.522e-4
# against 0.329, TN 6.951e-7 against 4.935e-4 (the CPU twins at the tests'
# 24 atoms: 2.3e-3 / 0.72, 8.0e-4 / 0.26, 3.2e-6 / 1.9e-3).  Limits
# between, about as far from each:
FGM_GRAD_TOL = 2e-2
FGM_GRAD_L2_TOL = 2e-3
FGM_FORCE_L2_TOL = {"et": 2e-2, "t": 1e-2, "tn": 2e-5}
FGM_TIMED_STEPS = 3
FGM_PROFILED_STEPS = 2
# (H-3) a third derivative through each family's fused Functions (#1/#2/#3
# and their counterparts for the primals, the composable rule above) against
# the plain twin's, at the "medium" check shapes, per input as max|d| /
# max|want|: the second order's bf16 roundings (BWD2_TOL's) carried one
# differentiation further.  Measured on an NVIDIA H100 80GB HBM3: ET 1.3e-2,
# the Transformer 1.1e-2, TensorNet 7.8e-3 (the CPU twins' the same).
THIRD_TOL = 5e-2
# (H-CLI) examples/ET-MD17.yaml through the CLI with --force-grad-mode jvp:
# a few steps against the same steps by grad-of-grad (the same cut): the
# logged metrics' largest relative gap.  The weights of the two runs part
# by the modes' bf16 roundings each step (H-FGM's gradients): measured
# 3.1e-4 on an NVIDIA H100 80GB HBM3 (3.0e-4 with the CPU twins).
JVP_CLI_SPLIT = (32, 16, 16)  # four training steps of 8, one val and one test batch
JVP_CLI_RTOL = 5e-3
# (H-CKPT) the JAX package's checkpoint (tests/data/jax_et.ckpt, written by
# its save_checkpoint; tests/test_torch_jax_checkpoint.py makes it) served on
# the card: as written (composable f32) against the JAX energies and forces
# beside it (JAX on a CPU, f32), and fused bf16 through External.
JAX_CKPT = os.path.join("tests", "data", "jax_et.ckpt")
JAX_CKPT_REF = os.path.join("tests", "data", "jax_et_ref.npz")
JAX_CKPT_F32_TOL = 1e-4
# fused bf16 against JAX's f32: bf16 carries 8 significant bits, and these
# energies are sums over 18 atoms, not DHFR's 2489 (E2E_ENERGY_TOL's): the
# CPU twins' |dE|/|E| 2.2e-3 and max|dF|/max|F| 8.1e-3 at these weights.
JAX_CKPT_BF16_TOL = (1e-2, E2E_FORCE_TOL)


def _prefix(km):
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    return "et_message" if km is em else "t_message" if km is tmk else "tn_message"


def _path_launches(km):
    """{kernel row: launches since the last reset} of a fused family's three
    kernels and the ELL gather pair (#4/#5: the bf16 gathers of the
    composable tangent passes)."""
    from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg

    p = _prefix(km)
    fwd, bwd, bwd2, _ = _launches(km)
    return {f"{p}_fwd": fwd, f"{p}_bwd": bwd, f"{p}_bwd2": bwd2, "ell_gather": eg.gather_rows.launches,
            "ell_transpose_sum": eg.transpose_sum_rows.launches}


def _check_family_parts(path, km, bwd, bwd2):
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    if km is em:
        return _check_et_parts(path, bwd, bwd2)
    if km is tmk:
        return _check_t_parts(path, bwd, bwd2)
    return _check_tn_parts(path, 0, bwd + bwd2)


def _grad_gaps(got, want):
    """({tensor: max|d| / max|want|}, |d| / |want| over every tensor)."""
    per = {k: _rel(got[k], v) for k, v in want.items()}
    num = sum(float((got[k].double() - v.double()).pow(2).sum()) for k, v in want.items())
    den = sum(float(v.double().pow(2).sum()) for v in want.values())
    return per, math.sqrt(num / den)


@contextlib.contextmanager
def _dropped_backward_tangent():
    """H-FGM's planted fault: every fused backward's tangent zero, as a
    backward that ran its kernel outside its Function would leave it."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import derivatives

    sound = derivatives.vjp_tangent

    def dropped(fn, primals, cts, t_primals, t_cts):
        return [None if p is None else torch.zeros_like(p) for p in primals]

    derivatives.vjp_tangent = dropped
    try:
        yield
    finally:
        derivatives.vjp_tangent = sound


def _untimed(kernel, path):
    """Whether no timing of this run is at the shape ``path`` runs
    ``kernel``: the slice-H1 paths that ``main``'s table of timed shapes
    leaves out."""
    if path.startswith("third_") or path == "jax_ckpt_external":
        return True
    return kernel in ("ell_gather", "ell_transpose_sum") and (path.startswith("fgm_") or "jvp" in path)


def _jvp_with_remat(model, args, h, batch, zero, km, layers, want, kind):
    """(H2-REMAT) ``model``'s jvp step (``h``) on the same batch again with
    remat (``args``' model with ``model``'s weights): each fused forward's
    outputs replayed in the three passes' recomputations with its tangent
    rules kept, so the launches stay (3L,
    3L, 0), the replays are 3L, and the gradients equal ``want`` (the step
    without remat) within REMAT_TOL.  Returns (the largest max|dg|/max|g|,
    whether bitwise, the launches, the replays)."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.kernels import save_list
    from torchmdnet_tpu_torch.train.trainer import Trainer

    remat = create_model(dict(args, remat=True), seed=SEED)
    remat.module.load_state_dict(model.module.state_dict())
    trainer = Trainer(remat, h)
    _reset_launches()
    save_list.reset_replays()
    trainer.step_gradients(batch, zero, zero)
    torch.cuda.synchronize()
    launches, replays = _launches(km)[:3], dict(save_list.replays)
    got = {n: q.grad.detach() for n, q in zip(trainer.param_names, trainer.params)}
    gap = max(_rel(got[k], v) for k, v in want.items())
    bitwise = all(torch.equal(got[k], v) for k, v in want.items())
    kernel = f"{_prefix(km)}_fwd"
    if launches != (3 * layers, 3 * layers, 0) or replays != {kernel: 3 * layers}:
        raise AssertionError(f"H2-REMAT {kind} jvp step with remat: launches {launches}, replays {replays}; "
                             f"expected {(3 * layers, 3 * layers, 0)} and {{{kernel!r}: {3 * layers}}}")
    if gap > REMAT_TOL:
        raise AssertionError(f"H2-REMAT {kind}: the jvp step's gradients with remat differ from those without: "
                             f"{gap}")
    return gap, bitwise, launches, replays


def force_grad_modes(train_ds, tn_ds, workdir):
    """(H-FGM) ET (8 x 256), the Transformer (8 x 256) and TensorNet-ANI1X
    (2 x 128) fused bf16 at their training shapes: one step's gradients
    (``Trainer.step_gradients``, no optimizer step) by grad-of-grad and in
    ``force_grad_mode="jvp"`` from the same weights and batch.  Checks: the
    gradients agree (FGM_GRAD_TOL, FGM_GRAD_L2_TOL), those of the force loss
    alone too (FGM_FORCE_L2_TOL), and the same jvp step of the force loss
    with the fused backward's tangent dropped does not (the planted fault,
    over FGM_FORCE_L2_TOL); a gradgrad step launches
    (L, 2L, L) of (forward, backward, second order) for L layers, a jvp step
    (3L, 3L, 0): no second-order kernel.  Times each mode's step three ways:
    host clock with a sync (median of FGM_TIMED_STEPS), CUDA events (the
    same, the host's enqueue inside the window) and the device's busy time
    (torch.profiler, mean of FGM_PROFILED_STEPS: the host's enqueue kept
    out), beside its peak memory.  Returns ({path: launches}, {kernel row:
    {path: (ms, bound_ms)}} is left to the caller)."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.train.trainer import Trainer

    paths, failures = {}, []
    for kind in ("et", "t", "tn"):
        cfg = _train_cfg(kind)
        args, km = cfg["args"], cfg["km"]
        layers = args["num_layers"]
        ds = tn_ds if kind == "tn" else train_ds
        batch = _train_batch(ds, "cuda", cfg["batch"], args["cutoff_upper"], cfg["mol"])
        model = create_model(args, seed=SEED)
        zero = torch.zeros((), device="cuda")
        grads, stats, hs = {}, {}, {}
        for mode in ("gradgrad", "jvp"):
            h = hs[mode] = dict(args, lr=cfg["lr"], y_weight=cfg["weights"][0], neg_dy_weight=cfg["weights"][1],
                                force_grad_mode=mode, log_dir=os.path.join(workdir, f"fgm_{kind}_{mode}"))
            trainer = Trainer(model, h)

            def step(trainer=trainer):
                trainer.step_gradients(batch, zero, zero)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            step()
            torch.cuda.synchronize()
            launches = _path_launches(km)
            p = _prefix(km)
            path = f"fgm_{kind}_{mode}"
            _check_family_parts(path, km, launches[f"{p}_bwd"], launches[f"{p}_bwd2"])
            paths[path] = launches
            grads[mode] = {n: q.grad.detach().clone() for n, q in zip(trainer.param_names, trainer.params)}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            host = host_ms(step, reps=FGM_TIMED_STEPS, warmup=1)
            event = event_ms(step, reps=FGM_TIMED_STEPS, warmup=0)
            wall, busy, groups, other, other_launches, _ = kernel_profile(step, FGM_PROFILED_STEPS, cfg["kernels"])
            stats[mode] = dict(launches=launches, host=host, event=event, wall=wall, busy=busy, peak=peak,
                               shares=_shares(groups, other, busy), other=other_launches)
        want = {"gradgrad": (layers, 2 * layers, layers), "jvp": (3 * layers, 3 * layers, 0)}
        for mode, (f, b, b2) in want.items():
            got = stats[mode]["launches"]
            if (got[f"{p}_fwd"], got[f"{p}_bwd"], got[f"{p}_bwd2"]) != (f, b, b2):
                raise AssertionError(f"H-FGM {kind} {mode}: expected (fwd, bwd, bwd2) launches {(f, b, b2)}, "
                                     f"got {got}")
        remat = _jvp_with_remat(model, args, hs["jvp"], batch, zero, km, layers, grads["jvp"], kind)
        per, l2 = _grad_gaps(grads["jvp"], grads["gradgrad"])
        # the force loss alone, by both modes, and by jvp with the planted fault
        force = {}
        for mode, fault in (("gradgrad", False), ("jvp", False), ("dropped", True)):
            trainer = Trainer(model, dict(hs["jvp" if fault else mode], y_weight=0.0))
            with _dropped_backward_tangent() if fault else contextlib.nullcontext():
                trainer.step_gradients(batch, zero, zero)
            force[mode] = {n: q.grad.detach().clone() for n, q in zip(trainer.param_names, trainer.params)}
        _, force_l2 = _grad_gaps(force["jvp"], force["gradgrad"])
        fault_per, fault_l2 = _grad_gaps(force["dropped"], force["gradgrad"])
        worst = max(per, key=per.get)
        g, j = stats["gradgrad"], stats["jvp"]
        limit = FGM_FORCE_L2_TOL[kind]
        log(f"force_grad_mode jvp against gradgrad at the training shapes (H-FGM): "
            f"{cfg['label']} ({cfg['batch']} molecules, N={batch.num_atoms}): jvp against gradgrad over {len(per)} "
            f"parameter tensors max|dg|/max|g| worst {per[worst]:.3e} ({worst}; tol {FGM_GRAD_TOL}), median "
            f"{statistics.median(per.values()):.3e}, |dg|/|g| {l2:.3e} (tol {FGM_GRAD_L2_TOL}); the force loss "
            f"alone |dg|/|g| {force_l2:.3e} (tol {limit}), with the fused backward's tangent dropped (the planted "
            f"fault) {fault_l2:.3e} (worst tensor {max(fault_per.values()):.3e}); a step "
            + "; ".join(f"{mode}: host {s['host']:.3f} ms, CUDA events {s['event']:.3f} ms, device busy "
                        f"{s['busy']:.3f} ms (profiled wall {s['wall']:.3f} ms; {s['shares']}; {s['other']:.0f} "
                        f"other launches), peak {s['peak']:.2f} GiB, launches {s['launches']}"
                        for mode, s in stats.items())
            + f"; jvp / gradgrad: host {j['host'] / g['host']:.2f}x, device busy {j['busy'] / g['busy']:.2f}x; "
            f"the jvp step with remat (H2-REMAT): max|dg|/max|g| {remat[0]:.3e} from the one without (bitwise "
            f"{remat[1]}; tol {REMAT_TOL}), launches {remat[2]}, replays {remat[3]}")
        if per[worst] > FGM_GRAD_TOL or l2 > FGM_GRAD_L2_TOL or force_l2 > limit:
            failures.append(f"H-FGM {kind}: the jvp step's gradients disagree with gradgrad's")
        if fault_l2 <= limit:
            failures.append(f"H-FGM {kind}: a dropped backward tangent stays inside the limit {limit}")
        del grads, model, force, trainer
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


def _third(fn, leaves, firsts, seconds, probe):
    """A third derivative of ``fn(leaves)`` (its output(s) contracted with
    ``probe``): g = d/d``firsts``, g2 = d<g, g>/d``seconds``, both with
    their graphs, then d<g2, g2>/d(every leaf)."""
    import torch

    out = fn(leaves)
    outs = out if isinstance(out, tuple) else (out,)
    e = sum((o * w).sum() + 0.1 * (o * o).sum() for o, w in zip(outs, probe))
    g = torch.autograd.grad(e, [leaves[n] for n in firsts], create_graph=True)
    s = sum((x.float() * x.float()).sum() for x in g)
    g2 = torch.autograd.grad(s, [leaves[n] for n in seconds], create_graph=True)
    s2 = sum((x.float() * x.float()).sum() for x in g2)
    names = list(leaves)
    g3 = torch.autograd.grad(s2, [leaves[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if x is None else x for n, x in zip(names, g3)}


def third_derivative_probes():
    """(H-3) A third derivative through each fused family's Functions on the
    card (the forward, backward and second-order kernels for the primals;
    the second order's gradient composable: ``derivatives.Bwd2``) against
    the same third derivative of its plain twin, at the "medium" check
    shapes: ET and the Transformer at N 512, K 40, H 64; TensorNet in a
    periodic box at H 64.  Every float input a f32 leaf, cast to its dtype
    at the call.  Returns {path: launches}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    nbl, ins, cts = _kernel_inputs(512, 40, 64, 32, 3.5, seed=9)
    t_nbl, t_ins, t_ct = _t_kernel_inputs(512, 40, 64, 32, 3.5, seed=10)
    tn_nbl, tn_pos, box = _tn_system("box", 11)
    tn_ins, tn_ct = _tn_kernel_inputs(tn_nbl, tn_pos, 64, TN_ARGS["num_rbf"], TN_ARGS["cutoff_upper"], 11, box=box)
    families = (
        ("ET", em, ins, ORDER, nbl, cts, ("q", "dir0"), ("k", "ea"),
         lambda f, nb, a: f(nb.idx, *a, heads=4, perm=nb.transpose_perm),
         (em.fused_et_messages, em.et_messages_reference)),
        ("Transformer", tmk, t_ins, T_ORDER, t_nbl, (t_ct,), ("q", "cutm"), ("k", "ea"),
         lambda f, nb, a: f(nb.idx, *a, heads=4, perm=nb.transpose_perm),
         (tmk.fused_t_messages, tmk.t_messages_reference)),
        ("TensorNet", tm, tn_ins, TN_ORDER, tn_nbl, (tn_ct,), ("cat", "cutm"), ("ea", "w1"),
         lambda f, nb, a: f(nb.idx, *a, perm=nb.transpose_perm),
         (tm.fused_tn_messages, tm.tn_messages_reference)),
    )
    paths, parts = {}, []
    for label, km, inputs, order, nb, probe, firsts, seconds, call, (fused, plain) in families:
        dtypes = {n: None if v is None else v.dtype for n, v in inputs.items()}
        got = {}
        for name, fn in (("fused", fused), ("plain", plain)):
            leaves = {n: v.float().clone().requires_grad_(True) for n, v in inputs.items()
                      if v is not None and n != "msk"}

            def f(lv, fn=fn):
                args = [None if inputs[n] is None else inputs[n] if n == "msk" else lv[n].to(dtypes[n])
                        for n in order]
                return call(fn, nb, args)

            _reset_launches()
            got[name] = _third(f, leaves, firsts, seconds, probe)
            torch.cuda.synchronize()
            if name == "fused":
                launches = _path_launches(km)
        p = _prefix(km)
        if launches[f"{p}_bwd2"] < 1:
            raise AssertionError(f"H-3 {label}: the third derivative ran no second-order kernel: {launches}")
        paths[f"third_{p.split('_')[0]}"] = launches
        rel = {n: _rel(got["fused"][n], v) for n, v in got["plain"].items() if float(v.abs().max()) > 0}
        worst = max(rel, key=rel.get)
        parts.append(f"{label} (N={nb.idx.shape[0]} K={nb.idx.shape[1]}): max|d|/max|want| worst {rel[worst]:.3e} "
                     f"({worst}), median {statistics.median(rel.values()):.3e}; launches {launches}")
        if rel[worst] > THIRD_TOL:
            raise AssertionError(f"H-3 {label}: the third derivative disagrees with the plain twin's: {parts[-1]}")
    log(f"third derivatives through the fused Functions against the plain twins (H-3; tol {THIRD_TOL}): "
        + "; ".join(parts))
    return paths


def md17_jvp_cli(workdir):
    """(H-CLI) examples/ET-MD17.yaml through the training CLI with
    ``--force-grad-mode jvp`` (fused bf16, the rMD17-format file that
    ``md17_training`` wrote under ``workdir``), cut to JVP_CLI_SPLIT and one
    epoch, against the same run by grad-of-grad.  Checks the jvp run's
    launches ((3, 3, 0) per layer a step, (1, 1, 0) an evaluation batch),
    finite losses, and every logged metric within JVP_CLI_RTOL of the
    gradgrad run's.  Returns {path: launches}."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.scripts import train as cli

    root = os.path.join(workdir, "data")
    train, val, test = JVP_CLI_SPLIT
    rows, launches, seconds = {}, {}, {}
    for mode in ("jvp", "gradgrad"):
        logs = os.path.join(workdir, f"logs_{mode}")
        flags = ["--conf", os.path.join(ROOT, MD17_CONF), "--dataset-root", root,
                 "--dataset-arg", json.dumps({"molecules": MD17_MOLECULE}), "--train-size", str(train),
                 "--val-size", str(val), "--test-size", str(test), "--num-epochs", "1",
                 "--lr-warmup-steps", str(MD17_WARMUP_STEPS), "--save-interval", "1", "--fused-attention", "true",
                 "--bf16-messages", "true", "--seed", str(SEED), "--num-workers", "0", "--log-dir", logs,
                 "--force-grad-mode", mode]
        _reset_launches()
        t0 = time.perf_counter()
        trainer, test_metrics = cli.main(flags)
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - t0
        launches[mode] = _path_launches(em)
        if mode == "jvp":
            _check_et_parts("md17_jvp_train", launches[mode]["et_message_bwd"], launches[mode]["et_message_bwd2"])
        with open(os.path.join(logs, "metrics.csv")) as f:
            rows[mode] = [{k: float(v) for k, v in r.items() if v not in ("", None)} for r in csv.DictReader(f)]
        if trainer.h["force_grad_mode"] != mode or not all(
                math.isfinite(v) for r in rows[mode] for v in r.values()):
            raise AssertionError(f"H-CLI {mode}: the run did not train in its mode: {rows[mode]}")
    h = trainer.h
    layers, bs, ibs = h["num_layers"], h["batch_size"], h["inference_batch_size"]
    steps, evals = train // bs, -(-val // ibs) + -(-test // ibs)
    want = (layers * (3 * steps + evals), layers * (3 * steps + evals), 0)
    got = tuple(launches["jvp"][f"et_message_{k}"] for k in ("fwd", "bwd", "bwd2"))
    if got != want:
        raise AssertionError(f"H-CLI: expected jvp launches {want} for {steps} steps and {evals} evaluation "
                             f"batches, got {got}")
    gap = _rows_gap(rows["gradgrad"], rows["jvp"])
    log(f"ET-MD17 training CLI with --force-grad-mode jvp (H-CLI; {layers}x{h['embedding_dimension']} fused bf16, "
        f"splits {JVP_CLI_SPLIT}, 1 epoch: {steps} steps): {seconds['jvp']:.1f} s (gradgrad {seconds['gradgrad']:.1f}"
        f" s); launches {launches['jvp']} ({steps} steps x (3, 3, 0) x L + {evals} evaluation batches x (1, 1, 0) "
        f"x L, L={layers}); logged metrics against the gradgrad run's: largest gap {gap[0]:.3e} ({gap[1]}; tol "
        f"{JVP_CLI_RTOL}); jvp epoch {json.dumps({k: round(v, 5) for k, v in rows['jvp'][0].items()})}")
    if gap[0] > JVP_CLI_RTOL:
        raise AssertionError(f"H-CLI: the jvp run's metrics disagree with gradgrad's: {gap}")
    return {"md17_jvp_train": launches["jvp"]}


def jax_checkpoint_serving():
    """(H-CKPT) The JAX package's checkpoint served on the card: read by the
    port's decoder (no flax), loaded by ``load_model`` as written (composable
    f32) and through ``External(path)``, against the JAX energies and forces
    stored beside it (JAX_CKPT_F32_TOL), then fused bf16 through ``External``
    against them (JAX_CKPT_BF16_TOL) with #1/#2 counted.
    Returns {path: launches}."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch.calculators import External
    from torchmdnet_tpu_torch.data.batch import pad_molecules
    from torchmdnet_tpu_torch.models.potential import load_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.train.checkpoints import is_jax_checkpoint

    path = os.path.join(ROOT, JAX_CKPT)
    ref = np.load(os.path.join(ROOT, JAX_CKPT_REF))
    if not is_jax_checkpoint(path):
        raise AssertionError(f"{JAX_CKPT} is not a checkpoint of the JAX package")
    e_ref, f_ref = ref["energy"], ref["forces"]
    m = e_ref.shape[0]
    a = ref["z"].shape[0] // m
    z, pos = ref["z"].reshape(m, a), ref["pos"].reshape(m, a, 3)

    def errs(y, f):
        y, f = np.asarray(y, np.float64).reshape(-1), np.asarray(f, np.float64).reshape(-1, 3)
        return (float(np.abs(y - e_ref).max() / np.abs(e_ref).max()),
                float(np.abs(f - f_ref).max() / np.abs(f_ref).max()))

    model = load_model(path)
    batch = pad_molecules([{"z": z[i], "pos": pos[i]} for i in range(m)], num_atoms=m * a, device="cuda")
    y, f = model.energy_and_forces(batch)
    direct = errs(y.cpu(), f.cpu())
    ext = External(path, z)
    ye, fe = ext.calculate(torch.as_tensor(pos))
    served = errs(ye.cpu(), fe.cpu())
    fused = External((load_model(path, fused_attention=True, bf16_messages=True), None), z)
    _reset_launches()
    yf, ff = fused.calculate(torch.as_tensor(pos))
    torch.cuda.synchronize()
    launches = _path_launches(em)
    _check_et_parts("jax_ckpt_external", launches["et_message_bwd"], 0)
    fused_err = errs(yf.cpu(), ff.cpu())
    layers = model.args["num_layers"]
    log(f"JAX checkpoint served on the card (H-CKPT; {JAX_CKPT}, {os.path.getsize(path)} bytes, written by the JAX "
        f"package's save_checkpoint: ET {layers}x{model.args['embedding_dimension']}; {m} molecules of {a} atoms "
        f"against JAX's f32 energies and forces on a CPU): load_model |dE|/|E| {direct[0]:.3e}, max|dF|/max|F| "
        f"{direct[1]:.3e}; External(path) {served[0]:.3e} / {served[1]:.3e} (tol {JAX_CKPT_F32_TOL}); fused bf16 "
        f"through External {fused_err[0]:.3e} / {fused_err[1]:.3e} (tol {JAX_CKPT_BF16_TOL[0]} / "
        f"{JAX_CKPT_BF16_TOL[1]}), "
        f"launches {launches}")
    if max(direct + served) > JAX_CKPT_F32_TOL or any(e > t for e, t in zip(fused_err, JAX_CKPT_BF16_TOL)):
        raise AssertionError("H-CKPT: the JAX checkpoint does not serve JAX's energies and forces")
    if (launches["et_message_fwd"], launches["et_message_bwd"]) != (layers, layers):
        raise AssertionError(f"H-CKPT: expected ({layers}, {layers}) launches of #1/#2, got {launches}")
    return {"jax_ckpt_external": launches}


# --- slice H2: remat's save-list, profiling.py, the native collation --------

# bench.py runs its STMV MD lines with remat (bench.py:255-260): ET as ET_ARGS
# (6 x 128, K 80); TensorNet's tensornet_fused_stmv_force_md_ms_per_step is
# TN_ARGS (2 x 128, 32 RBFs, cutoff 4.5 A, K 64, fused;
# benchmarks/inference.py:56-60)
REMAT_MD_MODELS = {"ET": ET_ARGS, "TensorNet": TN_ARGS}
DIPOLE_SEEDS = (SEED, SEED + 1, SEED + 2, SEED + 3)
PROF_ITERS = 3
# H2-PROF: device_ms_per_iter of ET's STMV force evaluation (device-bound:
# 99 % busy) over one evaluation's CUDA-event window.  The two differ by the
# window's launch overhead, which the difference of k_hi and k_lo cancels.
# On a DHFR call (host-bound: 14.7 ms of device time in a 27-40 ms call) the
# ratio swung from 0.893 to 1.252 between runs on an NVIDIA H100 80GB HBM3
# at 700 W with the host's speed.  At STMV a timer that divided by k_hi
# instead of k_hi - k_lo reads 0.67, one that counted a window twice 2.
DEVICE_ITER_BAND = (0.9, 1.1)
DEVICE_ITER_K = (1, 3)
COLLATE_BIG_BATCH = 128  # benchmarks/training.py's and ET-QM9's batch


def _remat_forces(args, batch, km, label):
    """One force evaluation of ``args``' model with remat against one without
    (same weights, same list): each forward kernel launched L times and
    served L times by replay, one backward per layer; energies and forces
    within REMAT_TOL (bitwise where the order of sums allows).  Returns the
    gaps, whether the forces are bitwise equal, and the evaluation's peak
    GiB above what was allocated before it, without and with remat."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.kernels import save_list

    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    ref = create_model(args, seed=SEED)
    model = create_model(dict(args, remat=True), seed=SEED)
    model.module.load_state_dict(ref.module.state_dict())
    nbl = ref.neighbors(batch, **probe_cell_kwargs(batch, cutoff_upper=args["cutoff_upper"]))
    nbl.raise_on_overflow(f"{label} STMV list")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y0, f0 = ref.energy_and_forces(batch, nbl=nbl)
    torch.cuda.synchronize()
    peak0 = (torch.cuda.max_memory_allocated() - base) / 2**30
    _reset_launches()
    save_list.reset_replays()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y1, f1 = model.energy_and_forces(batch, nbl=nbl)
    torch.cuda.synchronize()
    peak1 = (torch.cuda.max_memory_allocated() - base) / 2**30
    layers = args["num_layers"]
    got = (km.run_fwd.launches, km.run_bwd.launches, dict(save_list.replays))
    kernel = f"{km.__name__.split('.')[-1]}_fwd"
    if got != (layers, layers, {kernel: layers}):
        raise AssertionError(f"{label}: one force evaluation with remat launched/replayed {got}, expected "
                             f"({layers}, {layers}, {{{kernel!r}: {layers}}})")
    gaps = (float((y1 - y0).abs().max() / y0.abs().max()), float((f1 - f0).abs().max() / f0.abs().max()),
            bool(torch.equal(f1, f0)), peak0, peak1)
    if max(gaps[:2]) > REMAT_TOL:
        raise AssertionError(f"{label}: energy/forces with remat differ from those without: {gaps}")
    del ref, model, nbl, y0, f0, y1, f1
    return gaps


@contextlib.contextmanager
def _whole_layer_remat():
    """Remat without the save-list: each recomputed layer runs its fused
    forward kernel again (the JAX package's nn.remat without a policy)."""
    from torch.utils.checkpoint import noop_context_fn

    from torchmdnet_tpu_torch.ops.kernels import save_list

    contexts = save_list.contexts
    save_list.contexts = noop_context_fn
    try:
        yield
    finally:
        save_list.contexts = contexts


def _timed_md(model, batch, km, every, warmup, timed):
    """``warmup`` + ``timed`` MD steps through md.Simulation at a rebuild
    every ``every`` steps: (the Simulation, ms/step of the timed steps on the
    host clock with sync, (fwd, bwd, select_topk) launches, replays, peak
    GiB since the Simulation was made, the positions at each rebuild)."""
    import torch

    from torchmdnet_tpu_torch import Simulation
    from torchmdnet_tpu_torch.ops.kernels import save_list
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = Simulation(model, batch, seed=SEED, **dict(MD_ARGS, rebuild_every=every))
    sim.set_velocities_from_temperature(300.0)
    _reset_launches()
    save_list.reset_replays()
    starts = []
    for _ in range(warmup // every):
        starts.append(sim.state.pos)
        sim.step(every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed // every):
        starts.append(sim.state.pos)
        sim.step(every)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / timed
    launches = (km.run_fwd.launches, km.run_bwd.launches, select_topk.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return sim, ms, launches, dict(save_list.replays), peak, starts


def _md_counts_ok(label, launches, replays, kernel, layers, steps, every):
    evaluations, rebuilds = steps + 1, steps // every
    want = (layers * evaluations, layers * evaluations, rebuilds)
    if launches != want or replays != {kernel: layers * evaluations}:
        raise AssertionError(f"{label}: launches {launches}, replays {replays}; expected {want} and "
                             f"{{{kernel!r}: {layers * evaluations}}} ({evaluations} evaluations, {rebuilds} rebuilds)")


def check_tn_stmv(nbl, ins, ct, seed):
    """#8 and #9 (frozen weights, as MD runs it) at TensorNet's STMV skin
    list against their plain versions, as ``check_stmv`` does ET's: #8 on
    every receiver row in chunks of STMV_CHECK_ROWS; #9 on the cotangents of
    STMV_CHECK_ATOMS random atoms S, the receiver side (d_ea, d_cutm of S's
    rows) by autograd through the plain version of S's rows, the source side
    (d_cat) through the K edges pointing at each atom of S, each edge a row
    of an identity list.  Returns ({output: max rel err}, max abs err of the
    forward, of the backward); raises past TN_FWD_TOL or BWD_TOL."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    idx, perm = nbl.idx, nbl.transpose_perm
    n, kk = idx.shape
    w = [ins[x] for x in TN_ORDER[3:]]
    m = tm.run_fwd(idx, *[ins[x] for x in TN_ORDER], act="silu")
    fwd = []
    for r0 in range(0, n, STMV_CHECK_ROWS):
        r = slice(r0, min(n, r0 + STMV_CHECK_ROWS))
        fwd.append((m[r], tm.tn_messages_reference(idx[r], ins["cat"], ins["ea"][r], ins["cutm"][r], *w,
                                                   perm=_no_perm)))
    rel = {"fwd_m": _max_rel(fwd)}
    fwd_abs = max(float((a - b).abs().max()) for a, b in fwd)
    del m, fwd
    got = dict(zip(("cat", "ea", "cutm"), tm.run_bwd(idx, *[ins[x] for x in TN_ORDER], ct, act="silu",
                                                      want_weight_grads=False)[:3]))
    g = torch.Generator().manual_seed(seed)
    atoms = torch.randperm(n, generator=g)[:STMV_CHECK_ATOMS].sort().values.to(idx.device)
    t = {x: ins[x][atoms].clone().requires_grad_() for x in ("ea", "cutm")}
    out = tm.tn_messages_reference(idx[atoms], ins["cat"], t["ea"], t["cutm"], *w, perm=_no_perm)
    want = dict(zip(("ea", "cutm"), torch.autograd.grad(out, [t["ea"], t["cutm"]], ct[atoms])))
    edges = perm.reshape(n, kk)[atoms].reshape(-1).long()
    recv, me = torch.div(edges, kk, rounding_mode="floor"), edges.numel()
    if not torch.equal(idx.reshape(-1)[edges].reshape(-1, kk)[:, 0], atoms):
        raise AssertionError("transpose_perm's groups do not point at their atoms")
    ident = torch.arange(me, dtype=torch.int32, device=idx.device)
    src = ins["cat"][atoms].repeat_interleave(kk, dim=0).clone().requires_grad_()
    e_ea = ins["ea"].reshape(n * kk, -1)[edges].reshape(me, 1, -1)
    e_cutm = ins["cutm"].reshape(-1)[edges].reshape(me, 1)
    out = tm.tn_messages_reference(ident.reshape(me, 1), src, e_ea, e_cutm, *w, perm=ident)
    (gs,) = torch.autograd.grad(out, [src], ct[recv])
    want["cat"] = gs.float().reshape(len(atoms), kk, -1).sum(1)
    bwd_abs = 0.0
    for x, b in want.items():
        a = got[x][atoms]
        rel[f"bwd_{x}"] = _rel(a, b)
        bwd_abs = max(bwd_abs, float((a.float() - b.float()).abs().max()))
    torch.cuda.synchronize()
    fwd_err = rel["fwd_m"]
    bwd_err = max(v for k, v in rel.items() if k.startswith("bwd"))
    log(f"TensorNet kernel check at the STMV skin list (N={n} K={kk} H={ins['cat'].shape[1] // 9} "
        f"RBF={ins['ea'].shape[-1]}; #8 on every row in chunks of {STMV_CHECK_ROWS}, #9 frozen on {len(atoms)} "
        f"random atoms, both sides): fwd max rel err {fwd_err:.3e} (tol {TN_FWD_TOL}), bwd max rel err "
        f"{bwd_err:.3e} (tol {BWD_TOL}) {_fmt(rel)}")
    if fwd_err > TN_FWD_TOL or bwd_err > BWD_TOL:
        raise AssertionError(f"TensorNet kernels disagree with their plain versions at the STMV skin list: {rel}")
    return rel, fwd_abs, bwd_abs


def remat_md_stmv(et_md):
    """(H2-REMAT) bench.py's STMV MD lines under remat through md.Simulation
    on 30,336 padded atoms at full width, each fused forward's outputs kept
    and served again in each layer's recomputation (``save_list``).

    ET (6 x 128, K 80, skin 0.5 A, fused, remat): one force evaluation
    against one without remat; bench.py's cadence (a rebuild every 10
    steps): #1 and #2 L times per force evaluation (not 2L #1), #6 per
    rebuild, L replays per evaluation; ms/step and peak memory beside
    ``et_md`` (ms/step, peak GiB without remat, this run).

    TensorNet (2 x 128, 32 RBFs, 4.5 A, K 64, fused, remat; never run on the
    card before): the same evaluation check; MD_VALID_EVERY (where the skin
    holds): stale False, the refined list a fresh one's, two runs bitwise;
    bench.py's cadence for the time (its lists go stale, as ET's); #8 and #9
    checked and timed at its STMV skin list, #6 at its skin build.

    Returns ({path: {kernel: launches}}, {kernel: {path: (ms, bound_ms)}},
    #8's and #9's largest absolute errors at the skin list, the two
    Simulations at bench.py's cadence for the profiles)."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk, select_topk_reference

    batch = _stmv_batch()
    real = batch.atom_mask
    steps, every = MD_WARMUP_STEPS + MD_TIMED_STEPS, MD_ARGS["rebuild_every"]
    half_skin = 0.5 * MD_ARGS["neighbor_skin"]
    paths, timed_at = {}, {}

    def largest_move(starts, end):
        ends = starts[1:] + [end]
        return max(float((b - a).norm(dim=-1)[real].max()) for a, b in zip(starts, ends))

    # ET
    args, layers = REMAT_MD_MODELS["ET"], REMAT_MD_MODELS["ET"]["num_layers"]
    gaps = _remat_forces(args, batch, em, "ET")
    model = create_model(dict(args, remat=True), seed=SEED)
    sim, ms, launches, replays, peak, starts = _timed_md(model, batch, em, every, MD_WARMUP_STEPS, MD_TIMED_STEPS)
    _md_counts_ok("ET STMV MD with remat", launches, replays, "et_message_fwd", layers, steps, every)
    _check_et_parts("md_stmv_remat", launches[1], 0)
    state = sim.state
    if not (torch.isfinite(state.pos).all() and torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite positions or energies in ET MD with remat")
    if not torch.equal(state.pos[~real], batch.pos[~real]):
        raise AssertionError("padding atoms moved")
    move = largest_move(starts, state.pos)
    if move > half_skin and not bool(state.stale):
        raise AssertionError(f"atoms moved {move:.3f} A between rebuilds (> skin/2) but stale is False")
    paths["md_stmv_remat"] = dict(zip(("et_message_fwd", "et_message_bwd", "select_topk"), launches))
    # the same steps with the layers recomputed whole (no save-list: each
    # recomputation launches #1 again), in this process
    with _whole_layer_remat():
        _, whole_ms, whole_launches, _, whole_peak, _ = _timed_md(model, batch, em, every, MD_WARMUP_STEPS,
                                                                   MD_TIMED_STEPS)
    if whole_launches[0] != 2 * launches[0]:
        raise AssertionError(f"whole-layer remat launched #1 {whole_launches[0]} times, not {2 * launches[0]}")
    log(f"H2-REMAT: ET STMV MD with remat (bench.py's et_fused_stmv_force_md line: {layers}x"
        f"{args['embedding_dimension']} fused bf16, K {args['max_num_neighbors']}, {int(real.sum())} atoms padded "
        f"to {batch.num_atoms}, {MD_ARGS}): one evaluation against no remat |dE|/|E| {gaps[0]:.3e}, "
        f"max|dF|/max|F| {gaps[1]:.3e} (bitwise {gaps[2]}; tol {REMAT_TOL}); {steps} steps: launches #1 "
        f"{launches[0]} #2 {launches[1]} #6 {launches[2]} ({steps + 1} evaluations x {layers}, {steps // every} "
        f"rebuilds; without the save-list #1 would launch {2 * launches[0]}), replays {replays}; {ms:.3f} ms/step "
        f"(host clock with sync, mean of {MD_TIMED_STEPS}) against {et_md[0]:.3f} without remat; peak memory "
        f"{peak:.2f} GiB against {et_md[1]:.2f} GiB without remat; stale {bool(state.stale)} (largest move "
        f"{move:.3f} A against skin/2 {half_skin} A); one force evaluation's peak above what it found "
        f"allocated {gaps[4]:.2f} GiB with remat, {gaps[3]:.2f} GiB without; the layers recomputed whole (no "
        f"save-list, the same steps): #1 {whole_launches[0]} launches, {whole_ms:.3f} ms/step, peak "
        f"{whole_peak:.2f} GiB")
    et_sim = sim
    del model, state, starts

    # TensorNet
    args, layers = REMAT_MD_MODELS["TensorNet"], REMAT_MD_MODELS["TensorNet"]["num_layers"]
    tn_gaps = _remat_forces(args, batch, tm, "TensorNet")
    model = create_model(dict(args, remat=True), seed=SEED)
    valid_steps = MD_VALID_STEPS
    runs = []
    for _ in range(2):
        run = _timed_md(model, batch, tm, MD_VALID_EVERY, 0, valid_steps)
        _md_counts_ok("TensorNet STMV MD with remat", run[2], run[3], "tn_message_fwd", layers, valid_steps,
                      MD_VALID_EVERY)
        runs.append(run)
    (a, v_ms, _, _, v_peak, vstarts), (b, *_) = runs
    if not torch.equal(a.state.pos, b.state.pos):
        raise AssertionError("two TensorNet Simulations from the same batch and seed diverged")
    if not (torch.isfinite(a.state.pos).all() and torch.isfinite(a.state.energy).all()):
        raise AssertionError("non-finite positions or energies in TensorNet MD")
    if not torch.equal(a.state.pos[~real], batch.pos[~real]):
        raise AssertionError("padding atoms moved")
    vmove = largest_move(vstarts, a.state.pos)
    if bool(a.state.stale):
        raise AssertionError(f"TensorNet's skin list went stale at rebuild_every={MD_VALID_EVERY} ({vmove:.3f} A)")
    if _pairs_against_fresh(a, model, batch, vstarts[-1], args)[:2] != (0, 0):
        raise AssertionError("TensorNet's refined skin list and a fresh list hold different pairs")
    skin_nbl = a._build_nbl(a.state.pos)
    pos = a.state.pos
    del runs, b
    sim, ms, launches, replays, peak, starts = _timed_md(model, batch, tm, every, MD_WARMUP_STEPS, MD_TIMED_STEPS)
    _md_counts_ok("TensorNet STMV MD with remat at bench.py's cadence", launches, replays, "tn_message_fwd",
                  layers, steps, every)
    _check_tn_parts("tn_md_stmv_remat", 0, 0)
    move = largest_move(starts, sim.state.pos)
    stale = bool(sim.state.stale)
    if move > half_skin and not stale:
        raise AssertionError(f"atoms moved {move:.3f} A between rebuilds (> skin/2) but stale is False")
    missed, extra, total = _pairs_against_fresh(sim, model, batch, starts[-1], args)
    if extra:
        raise AssertionError(f"TensorNet's refined skin list holds {extra} pairs that a fresh list does not")
    paths["tn_md_stmv_remat"] = dict(zip(("tn_message_fwd", "tn_message_bwd", "select_topk"), launches))
    tn_sim = sim
    del starts

    # #8 and #9 at the skin list this path runs, #6 at its skin build
    h, rbf = args["embedding_dimension"], args["num_rbf"]
    ins, ct = _tn_kernel_inputs(skin_nbl, pos, h, rbf, args["cutoff_upper"], SEED)
    rel, fwd_abs, bwd_abs = check_tn_stmv(skin_nbl, ins, ct, SEED)
    idx, n, kk = skin_nbl.idx, *skin_nbl.idx.shape
    ops = [ins[x] for x in TN_ORDER]
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    fwd_ms = event_ms(lambda: tm.run_fwd(idx, *ops, act="silu"), flush=flush, reps=5)
    bwd_ms = event_ms(lambda: tm.run_bwd(idx, *ops, ct, act="silu", want_weight_grads=False), flush=flush, reps=5)
    fwd_bound, bwd_bound = _tn_bounds(n, kk, h, rbf, "fwd"), _tn_bounds(n, kk, h, rbf, "bwd")
    keys, k, _ = cell_keys(args, batch, skin=MD_ARGS["neighbor_skin"])
    if not torch.equal(select_topk(keys, k, keys.shape[0]), select_topk_reference(keys, k)):
        raise AssertionError("#6 disagrees with its plain version at TensorNet's STMV skin build")
    sel_ms = event_ms(lambda: select_topk(keys, k, keys.shape[0]), flush=flush)
    sel_bound = _select_topk_bounds(keys, k, keys.shape[0])[:2]
    timed_at = {"tn_message_fwd": {"tn_md_stmv_remat": (fwd_ms, fwd_bound[0])},
                "tn_message_bwd": {"tn_md_stmv_remat": (bwd_ms, bwd_bound[0])},
                "select_topk": {"tn_md_stmv_remat": (sel_ms, sel_bound[0])}}
    log(f"H2-REMAT: TensorNet STMV MD with remat (bench.py's tensornet_fused_stmv_force_md line: {layers}x{h} "
        f"fused bf16, RBF {rbf}, cutoff {args['cutoff_upper']} A, K {args['max_num_neighbors']}, skin list K {kk}): "
        f"one evaluation against no remat |dE|/|E| {tn_gaps[0]:.3e}, max|dF|/max|F| {tn_gaps[1]:.3e} (bitwise "
        f"{tn_gaps[2]}; the evaluation's peak {tn_gaps[4]:.2f} GiB with remat, {tn_gaps[3]:.2f} without); rebuild "
        f"every {MD_VALID_EVERY}: {valid_steps} steps, {v_ms:.3f} ms/step, peak "
        f"{v_peak:.2f} GiB, largest move {vmove:.3f} A, stale False, two runs bitwise equal, the refined list a "
        f"fresh one's; bench.py's cadence (every {every}): {steps} steps, launches #8 {launches[0]} #9 "
        f"{launches[1]} #6 {launches[2]}, replays {replays}, {ms:.3f} ms/step (host clock with sync, mean of "
        f"{MD_TIMED_STEPS}), peak {peak:.2f} GiB, stale {stale} (largest move {move:.3f} A), the refined list misses "
        f"{missed} of a fresh list's {total} pairs; at its skin list (N={n} K={kk}, L2 flushed, median of 5) #8 "
        f"{fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f} ms by {fwd_bound[1]}), #9 frozen {bwd_ms:.4f} ms (bound "
        f"{bwd_bound[0]:.4f} ms by {bwd_bound[1]}); #6 at its skin build (N={keys.shape[0]} W={keys.shape[1]} "
        f"k={k}, median of 20) {sel_ms:.4f} ms (bound {sel_bound[0]:.4f} ms by {sel_bound[1]})")
    del model, a, ins, ct, skin_nbl, keys
    return paths, timed_at, (fwd_abs, bwd_abs), (et_sim, tn_sim)


def _evaluation_step(sim):
    """``sim``'s force evaluation on its refined skin list as a
    ``device_ms_per_iter`` step: the positions chain each step's forces
    (times a zero)."""
    import torch

    forces = sim._skin_list(sim.state.pos)[0]

    @torch.no_grad()
    def step(p, eps):
        return p + eps * forces(p)[1]

    return step


def profiling_phase(ext, pos, sim):
    """(H2-PROF) ``profiling.trace`` of DHFR ET calls read back by
    ``trace_summary``, which must name #1's and #2's kernels with PROF_ITERS
    launches per layer and call; ``device_ms_per_iter`` of ``sim``'s force
    evaluation (ET's STMV MD on its refined skin list) whose positions chain
    each step's forces (times a zero), against the CUDA-event window of one
    evaluation (within DEVICE_ITER_BAND)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    layers = ET_ARGS["num_layers"]
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            for _ in range(PROF_ITERS):
                with profiling.scope("et_dhfr_call"):
                    ext.calculate(pos)
        rows = profiling.trace_summary(log_dir, top=8, iters=PROF_ITERS)
    by_name = {r["name"]: r for r in rows}
    for kernel in ("et_fwd_kernel", "et_bwd_kernel"):
        hits = [r for name, r in by_name.items() if kernel in name and "src" not in name]
        if not hits or sum(r["count"] for r in hits) != layers:
            raise AssertionError(f"trace_summary did not find {kernel} {layers} times a call: {hits}")
    total = sum(r["ms"] for r in rows)
    pos0 = sim.state.pos
    step = _evaluation_step(sim)
    k_lo, k_hi = DEVICE_ITER_K
    per_iter = profiling.device_ms_per_iter(step, pos0, k_lo=k_lo, k_hi=k_hi, reps=2)
    window = event_ms(lambda: step(pos0, torch.zeros((), device="cuda")), reps=5, warmup=1)
    _reset_launches()
    step(pos0, torch.zeros((), device="cuda"))
    torch.cuda.synchronize()
    log(f"H2-PROF: trace_summary of {PROF_ITERS} DHFR ET calls: device {total:.3f} ms/call over {len(rows)} "
        f"kernels, top: " + "; ".join(f"{r['name'][:48]} {r['ms']:.3f} ms x{r['count']:g}" for r in rows[:5])
        + f"; device_ms_per_iter of ET's STMV force evaluation (k {k_lo} to {k_hi}, best of 2, CUDA events) "
        f"{per_iter:.3f} ms against an evaluation's CUDA-event window {window:.3f} ms (median of 5), ratio "
        f"{per_iter / window:.3f} "
        f"(band {DEVICE_ITER_BAND}; fwd launches a step "
        f"{em.run_fwd.launches})")
    lo, hi = DEVICE_ITER_BAND
    if not lo < per_iter / window < hi:
        raise AssertionError(f"device_ms_per_iter {per_iter} ms is {per_iter / window:.3f} of the event window "
                             f"{window} ms, outside {DEVICE_ITER_BAND}")
    return per_iter, window


def native_collation(trainer, workdir):
    """(H2-COLLATE) ET-MD17's training loader with the native collation
    (``use_native=True``) against the numpy path (the default): every batch
    of an epoch bitwise, in the same dtypes, and ms per batch of each (host
    clock with sync: collation and the copy to the card; and collation alone
    on the host, at the loader's batch and at COLLATE_BIG_BATCH molecules,
    the training configurations' batch)."""
    import copy

    import torch

    from torchmdnet_tpu_torch.data import native_collate
    from torchmdnet_tpu_torch.data.batch import pad_molecules
    from torchmdnet_tpu_torch.data.module import DataModule

    data = DataModule(dict(trainer.h, num_workers=0, log_dir=os.path.join(workdir, "collate")))
    data.setup()
    slow = data.train_dataloader()
    fast = copy.copy(slow)
    fast.use_native = True
    if not (fast._native() and not slow._native()):
        raise AssertionError("ET-MD17's loader does not take the native collation")
    n = 0
    for a, b in zip(fast, slow):
        for f in ("z", "pos", "batch", "atom_mask", "mol_mask", "y", "neg_dy", "q", "s"):
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None) or (x is not None and (x.dtype != y.dtype or not torch.equal(x, y))):
                raise AssertionError(f"native and numpy batches differ in {f}")
        n += 1
    if n != len(fast):
        raise AssertionError(f"{n} batches of {len(fast)}")

    def epoch(loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in loader:
            pass
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / len(loader)

    loader_ms = {"native": min(epoch(fast) for _ in range(3)), "numpy": min(epoch(slow) for _ in range(3))}
    plan = fast._batch_plan()[0]
    mols = [data.dataset[int(i)] for i in plan[0]]
    alone = {"native": host_ms(lambda: native_collate.fast_pad_collate(mols, plan[1], fast.batch_size), reps=50),
             "numpy": host_ms(lambda: pad_molecules(mols, num_atoms=plan[1], num_mol=fast.batch_size), reps=50)}
    big = [data.dataset[i % len(data.dataset)] for i in range(COLLATE_BIG_BATCH)]
    cap = -(-sum(len(m["z"]) for m in big) // 8) * 8
    if not torch.equal(native_collate.fast_pad_collate(big, cap, len(big))["pos"],
                       pad_molecules(big, num_atoms=cap, num_mol=len(big)).pos):
        raise AssertionError(f"native and numpy collation differ at {len(big)} molecules")
    alone_big = {"native": host_ms(lambda: native_collate.fast_pad_collate(big, cap, len(big)), reps=50),
                 "numpy": host_ms(lambda: pad_molecules(big, num_atoms=cap, num_mol=len(big)), reps=50)}
    log(f"H2-COLLATE: ET-MD17's training loader ({n} batches of {fast.batch_size} molecules, capacity "
        f"{fast.num_atoms_pad} atoms), native collation against numpy: every batch bitwise equal, same dtypes; "
        f"ms per batch with the copy to the card (best of 3 epochs) native {loader_ms['native']:.4f}, numpy "
        f"{loader_ms['numpy']:.4f}; collation alone on the host (median of 50) native {alone['native']:.4f}, "
        f"numpy {alone['numpy']:.4f}; at {len(big)} molecules ({cap} atoms) native {alone_big['native']:.4f}, numpy "
        f"{alone_big['numpy']:.4f}")
    return loader_ms, alone, alone_big


# --- slice H3: the published configurations on the card ---------------------

H3_TN_KERNELS = ("tn_fwd_kernel", "tn_bwd_kernel", "tn_bwd2_kernel", "tn_src_sum_kernel", "et_dw_kernel")
# the keys of an examples/*.yaml file that the H3 phases override (the
# dataset and its files, the splits, the epochs, the log directory): every
# other key of the file must reach the trainer unchanged
EXAMPLE_OVERRIDES = ("dataset", "coord_files", "embed_files", "energy_files", "force_files", "train_size",
                     "val_size", "test_size", "num_epochs", "log_dir")
# molecules of the batch on which a configuration's fused gradient is held
# against the composable fp32 one, where not the whole training batch: the
# composable force-loss gradient of ET-SPICE's batch (N 3072, K 129, 8 x
# 256) ran out of the card's 80 GB (NVIDIA H100 80GB HBM3); a batch of 8 of
# its molecules (N 768, K 129) keeps the configuration
H3_GRAD_MOLECULES = {"ET-SPICE.yaml": 8}


def gn_remat_md_stmv():
    """(H3-GNREMAT) bench.py's gn_stmv_force_md_ms_per_step: GN 6 x 128, K 80,
    bf16 messages, with remat (``GN_REMAT_ARGS``), md.Simulation at STMV size
    (30,336 atoms, skin 0.5 A) at bench.py's cadence (a rebuild every 10
    steps) and at GN_MD_EVERY, each against the same steps without remat on
    the same weights: the positions at every rebuild and the final positions,
    energies and forces bitwise; #4 and #5 per force evaluation (GN stays
    whole-layer under remat, as JAX's: each recomputed layer gathers again,
    so 2L #4 and L #5 against L and L); #6 once a rebuild; ``stale`` (False
    required at GN_MD_EVERY, where the refined list must hold a fresh one's
    pairs); ms/step on the host clock, the device ms of one force evaluation
    (``profiling.device_ms_per_iter``) and the peak.  Returns {path: {kernel:
    launches}} of the remat runs."""
    import torch

    from torchmdnet_tpu_torch import create_model

    batch = _stmv_batch()
    real = batch.atom_mask
    km = _gn_km()
    layers = GN_ARGS["num_layers"]
    plain = create_model(GN_ARGS, seed=SEED, std=GN_MD_STD)
    remat = create_model(GN_REMAT_ARGS, seed=SEED, std=GN_MD_STD)
    remat.module.load_state_dict(plain.module.state_dict())
    paths, lines = {}, []
    for path, every, timed in (("gn_md_stmv_remat", MD_ARGS["rebuild_every"], GN_REMAT_STEPS),
                               ("gn_md_stmv_remat_valid", GN_MD_EVERY, GN_MD_TIMED_STEPS)):
        steps = every + timed
        evaluations, rebuilds = steps + 1, steps // every
        runs = {}
        for name, model, per_eval in (("no remat", plain, (1, 1)), ("remat", remat, (2, 1))):
            sim, ms, launches, _, peak, starts = _timed_md(model, batch, km, every, every, timed)
            want = (per_eval[0] * layers * evaluations, per_eval[1] * layers * evaluations, rebuilds)
            if launches != want:
                raise AssertionError(f"GN STMV MD ({name}, a rebuild every {every}): launches (#4, #5, #6) "
                                     f"{launches}, expected {want} ({evaluations} evaluations, {rebuilds} rebuilds)")
            state = sim.state
            if not (torch.isfinite(state.pos).all() and torch.isfinite(state.energy).all()):
                raise AssertionError(f"non-finite positions or energies in GN MD ({name})")
            if not torch.equal(state.pos[~real], batch.pos[~real]):
                raise AssertionError("padding atoms moved")
            ends = starts[1:] + [state.pos]
            move = max(float((b - a).norm(dim=-1)[real].max()) for a, b in zip(starts, ends))
            dev_ms = None
            if every == MD_ARGS["rebuild_every"]:
                dev_ms = profiling.device_ms_per_iter(_evaluation_step(sim), sim.state.pos, k_lo=DEVICE_ITER_K[0],
                                                      k_hi=DEVICE_ITER_K[1], reps=2)
            runs[name] = dict(sim=sim, ms=ms, launches=launches, peak=peak, starts=starts, move=move,
                              stale=bool(state.stale), dev_ms=dev_ms,
                              forces=sim._carried[1] if sim._carried[0] is state.pos else None)
        a, b = runs["no remat"], runs["remat"]
        same = (len(a["starts"]) == len(b["starts"]) and all(torch.equal(x, y) for x, y in zip(a["starts"], b["starts"]))
                and torch.equal(a["sim"].state.pos, b["sim"].state.pos)
                and torch.equal(a["sim"].state.energy, b["sim"].state.energy)
                and a["forces"] is not None and b["forces"] is not None and torch.equal(a["forces"], b["forces"]))
        if not same:
            raise AssertionError(f"GN STMV MD with remat (a rebuild every {every}) is not bitwise the run without")
        if b["stale"] != a["stale"]:
            raise AssertionError("stale differs with and without remat")
        if every == GN_MD_EVERY:
            if b["stale"]:
                raise AssertionError(f"GN's skin list went stale at rebuild_every={every} ({b['move']:.3f} A)")
            if _pairs_against_fresh(b["sim"], remat, batch, b["starts"][-1], GN_ARGS)[:2] != (0, 0):
                raise AssertionError("GN's refined skin list and a fresh list hold different pairs")
        elif b["move"] > 0.5 * MD_ARGS["neighbor_skin"] and not b["stale"]:
            raise AssertionError(f"atoms moved {b['move']:.3f} A between rebuilds (> skin/2) but stale is False")
        paths[path] = dict(zip(("ell_gather", "ell_transpose_sum", "select_topk"), b["launches"]))
        dev = "" if b["dev_ms"] is None else (f"; one force evaluation's device time (device_ms_per_iter) "
                                              f"{b['dev_ms']:.3f} ms with remat, {a['dev_ms']:.3f} ms without")
        lines.append(f"a rebuild every {every}: {steps} steps, positions, energies and forces bitwise with and "
                     f"without remat; launches (#4, #5, #6) {b['launches']} with remat ({2 * layers}, {layers} "
                     f"a force evaluation), {a['launches']} without; stale {b['stale']} (largest move between "
                     f"rebuilds {b['move']:.3f} A against skin/2 {0.5 * MD_ARGS['neighbor_skin']} A); "
                     f"{b['ms']:.3f} ms/step with remat, {a['ms']:.3f} without (host clock with sync, mean of "
                     f"{timed}){dev}; peak {b['peak']:.2f} GiB with remat, {a['peak']:.2f} GiB without")
        del runs, a, b
    log(f"H3-GNREMAT: GN STMV MD with remat (bench.py's gn_stmv_force_md line: {layers}x"
        f"{GN_ARGS['embedding_dimension']} bf16 messages, K {GN_ARGS['max_num_neighbors']}, {int(real.sum())} atoms "
        f"padded to {batch.num_atoms}, skin {MD_ARGS['neighbor_skin']} A, std {GN_MD_STD}): " + "; ".join(lines))
    del plain, remat
    return paths


def _trained_table(grads, batch):
    """The Atomref table's gradient: (elements in ``batch`` with a nonzero
    gradient, elements in it, elements outside it with a nonzero one)."""
    import torch

    (g,) = [v for k, v in grads.items() if k.endswith("atomref")]
    g = g.reshape(-1)
    present = torch.zeros_like(g, dtype=torch.bool)
    present[batch.z[batch.atom_mask].long().unique()] = True
    return int((g[present] != 0).sum()), int(present.sum()), int((g[~present] != 0).sum())


def example_training(workdir, conf, split, sizes, frames, forces):
    """(H3-SPICE-ET, H3-SPICE-TN, H3-QM9) ``examples/<conf>`` through the
    training CLI (``scripts.train.main --conf``), unchanged but for
    EXAMPLE_OVERRIDES: Custom npy files that ``write_custom_frames`` writes
    (seeded molecules of ``sizes`` atoms, Morse energies and, with
    ``forces``, forces), the splits, EXAMPLE_EPOCHS and the family's fused
    flags.  ``derivative`` and the learning-rate warmup come from the file.

    Checks: every other key of the file reached the trainer; launches per
    step (1, 2, 1) x L with the force loss or (1, 1, 0) x L with the energy
    loss and per evaluation batch (1, 1, 0) or (1, 0, 0) x L, and no #6
    (batches of small molecules take the brute search under "auto", as in
    JAX); losses finite, the validation loss falling; the checkpoint
    reloads; one gradient on a training batch from the loader (of
    H3_GRAD_MOLECULES molecules where named), fused bf16 against composable
    fp32 (TRAIN_GRAD_TOL); an Atomref prior's gradient nonzero on the
    elements present and zero elsewhere.  Then Trainer steps on that batch:
    ms/step (host clock with sync), launches and peak (``time_train_steps``)
    and the profiled busy share (``profile_train``).
    Returns ((fwd, bwd, bwd2, select_topk) launches, the trainer, the batch)."""
    import torch
    import yaml

    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
    from torchmdnet_tpu_torch.scripts import train as cli

    with open(os.path.join(EXAMPLES, conf)) as f:
        file_args = yaml.safe_load(f)
    model = file_args["model"]
    et = model == "equivariant-transformer"
    km, kernels = (em, MD17_KERNELS) if et else (tm, H3_TN_KERNELS)
    path = f"{conf[:-5].lower().replace('-', '_')}_train"
    t0 = time.perf_counter()
    data = write_custom_frames(os.path.join(workdir, "data"), sizes, frames, forces=forces)
    write_s = time.perf_counter() - t0
    logs = os.path.join(workdir, "logs")
    t0 = time.perf_counter()
    _reset_launches()
    trainer, test_metrics = cli.main(example_flags(conf, data, split, logs, model))
    torch.cuda.synchronize()
    launches = _launches(km)
    seconds = time.perf_counter() - t0
    h = trainer.h
    changed = {k: (h.get(k), v) for k, v in file_args.items() if k not in EXAMPLE_OVERRIDES and h.get(k) != v}
    if changed:
        raise AssertionError(f"{conf}: keys of the file did not reach the trainer unchanged: {changed}")
    derivative = h["derivative"]
    with open(os.path.join(logs, "metrics.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r.get("train_total_mse_loss")]
    train_losses = [float(r["train_total_mse_loss"]) for r in rows]
    val_losses = [float(r["val_total_mse_loss"]) for r in rows]
    first = trainer.first_step_loss
    values = train_losses + val_losses + [first] + [float(v) for v in test_metrics.values()]
    if len(rows) != EXAMPLE_EPOCHS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{conf}: training losses missing or not finite: {rows}, {test_metrics}")
    # the training batches mix molecules of several sizes, whose energies
    # differ by tens of eV, so a batch's loss swings with its sizes: the
    # losses compared are the validation set's, the same frames each epoch
    if not val_losses[-1] < val_losses[0]:
        raise AssertionError(f"{conf}: the last epoch's validation loss {val_losses[-1]} is not below the first "
                             f"epoch's {val_losses[0]}")
    layers, bs, ibs = h["num_layers"], h["batch_size"], h["inference_batch_size"]
    train, val, test = split
    steps = EXAMPLE_EPOCHS * (train // bs)
    evals = EXAMPLE_EPOCHS * -(-val // ibs) + -(-test // ibs)
    per_step, per_eval = ((1, 2, 1), (1, 1, 0)) if derivative else ((1, 1, 0), (1, 0, 0))
    expected = tuple(layers * (s * steps + e * evals) for s, e in zip(per_step, per_eval)) + (0,)
    if launches != expected or trainer.state.global_step != steps:
        raise AssertionError(f"{conf}: expected launches {expected} for {steps} steps and {evals} evaluation "
                             f"batches, got {launches} after {trainer.state.global_step} steps")
    reductions = launches[2] if derivative else layers * steps  # the weight cotangents of each training step
    if et:
        if _check_et_parts(path, launches[1], launches[2])["et_message_dw"] < reductions:
            raise AssertionError(f"{conf}: the weight reduction ran fewer than {reductions} times")
    else:
        _check_tn_parts(path, reductions, launches[1] + launches[2])
    best = _check_reload(trainer)

    def loader_batch(molecules):
        dm = DataModule(dict(h, batch_size=molecules, inference_batch_size=molecules, num_workers=0,
                             log_dir=os.path.join(workdir, f"loader{molecules}")))
        dm.setup()
        return trainer._prepare_batch(next(iter(dm.train_dataloader())))

    batch = loader_batch(bs)
    grad_batch = loader_batch(H3_GRAD_MOLECULES[conf]) if conf in H3_GRAD_MOLECULES else batch
    grads = {}
    cfg = dict(args=h, km=km, per_step=per_step, weights=(h["y_weight"], h["neg_dy_weight"]), label=conf)
    train_grads_vs_composable(None, cfg, batch=grad_batch, remat=False, grads_out=grads)
    table = ""
    if h["prior_model"] == "Atomref":
        nonzero, present, outside = _trained_table(grads, grad_batch)
        if nonzero != present or outside:
            raise AssertionError(f"{conf}: the Atomref table's gradient is nonzero on {nonzero} of the {present} "
                                 f"elements present and on {outside} others")
        table = (f"; the Atomref table (Custom carries none, so it starts from zeros, the rule both packages "
                 f"share) has a nonzero gradient on all {present} elements present and none elsewhere")
    del grads, grad_batch
    cfg.update(kernels=kernels, label=f"{conf} {layers}x{h['embedding_dimension']}")
    label = f"H3-{'SPICE' if 'SPICE' in conf else 'QM9'}-{'ET' if et else 'TN'}"
    log(f"{label}: scripts.train.main --conf {os.path.join('examples', conf)} ({layers}x{h['embedding_dimension']}, "
        f"RBF {h['num_rbf']}, cutoff {h['cutoff_upper']} A, K {h['max_num_neighbors']}, batches of {bs}, "
        f"derivative {derivative} from the file, prior {h['prior_model']}, fused bf16) on Custom npy files of "
        f"{frames} Morse-labelled frames of each of {sizes} atoms ({'energies and forces' if forces else 'energies only'}"
        f", written in {write_s:.1f} s); overridden: the dataset, splits {split}, {EXAMPLE_EPOCHS} epochs (the "
        f"file's {file_args['lr_warmup_steps']}-step warmup kept), the log dir and the fused flags: "
        f"first step loss {first:.4f}, epoch train losses {[round(v, 4) for v in train_losses]}, validation "
        f"losses {[round(v, 4) for v in val_losses]}, test "
        f"{json.dumps({k: round(v, 4) for k, v in test_metrics.items()})}; launches fwd {launches[0]} bwd "
        f"{launches[1]} bwd2 {launches[2]} select_topk {launches[3]} ({steps} steps x {per_step} x L + {evals} "
        f"evaluation batches x {per_eval} x L, L={layers}; the brute search, no #6); checkpoint "
        f"{os.path.basename(best)} reloads{table}; {seconds:.1f} s in all")
    # the step on a batch from the loader, timed and profiled
    time_train_steps(trainer, None, cfg, batch=batch)
    profile_train(trainer, batch, cfg)
    return launches, trainer, batch


def h3_kernel_times(et_spice, tn_spice, et_qm9, tn_qm9):
    """Each H3 path's kernels at the shapes it runs them (L2 flushed, median
    of 20; the plain second order of 5), with their plain versions and
    bounds: #1-#3 at ET-SPICE's training batch and #1/#2 at ET-QM9's
    (``time_train_kernels``), #8-#10 at TensorNet-SPICE's and #8/#9 at
    TensorNet-QM9's.  Each argument is (the trainer's hparams, a training
    batch).  Returns {kernel row: {path: (ms, bound_ms)}} and the rows
    {(path, kind): (ms, plain, bound, by, (N, K))}."""
    import torch

    timed_at, rows = {}, {}
    for path, (h, batch), kinds in (("et_spice_train", et_spice, ("fwd", "bwd_w", "bwd2")),
                                    ("et_qm9_train", et_qm9, ("fwd", "bwd_w"))):
        ms, plain, bounds = time_train_kernels(batch, f"{path}'s shapes", args=h, kinds=kinds)
        n, kk = batch.num_atoms, h["max_num_neighbors"] + 1
        for kind in kinds:
            rows[(path, kind)] = (ms[kind], plain.get(kind)) + bounds[kind] + ((n, kk),)
        timed_at.setdefault("et_message_fwd", {})[path] = (ms["fwd"], bounds["fwd"][0])
        timed_at.setdefault("et_message_bwd", {})[path] = (ms["bwd_w"], bounds["bwd_w"][0])
        if "bwd2" in kinds:
            timed_at.setdefault("et_message_bwd2", {})[path] = (ms["bwd2"], bounds["bwd2"][0])
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    for path, (h, batch), kinds in (("tensornet_spice_train", tn_spice, ("fwd", "bwd_w", "bwd2")),
                                    ("tensornet_qm9_train", tn_qm9, ("fwd", "bwd_w"))):
        hh, rbf, cut = h["embedding_dimension"], h["num_rbf"], h["cutoff_upper"]
        nbl, pos, box = _tn_system(batch, SEED, k=h["max_num_neighbors"], cutoff=cut)
        ins, ct = _tn_kernel_inputs(nbl, pos, hh, rbf, cut, SEED, box=box)
        got = _tn_times(nbl, ins, ct, _tn_z_like(ins, SEED), kinds, flush)
        for kind, row in got.items():
            rows[(path, kind)] = row
            name = {"fwd": "tn_message_fwd", "bwd_w": "tn_message_bwd", "bwd2": "tn_message_bwd2"}[kind]
            timed_at.setdefault(name, {})[path] = (row[0], row[2])
        del nbl, ins, ct
    log("H3 kernel times (L2 flushed, median of 20; plain second order of 5): " + "; ".join(
        f"{kind} at {path} N={v[4][0]} K={v[4][1]} {v[0]:.4f} ms (plain "
        + ("-" if v[1] is None else f"{v[1]:.4f}") + f" ms, bound {v[2]:.4f} ms by {v[3]}, "
        f"{100 * v[2] / v[0]:.1f}% of it reached)" for (path, kind), v in rows.items()))
    return timed_at, rows


def opt_dhfr(ext):
    """(H3-OPT) ``optimize()`` serving ET at DHFR size (ET_ARGS, 2489 atoms
    padded to 2496) with a 0.5 A skin and a rebuild every OPT_REBUILD_EVERY
    calls, over OPT_CALLS calls, each moving every atom by a seeded normal
    step of OPT_STEP A a coordinate; then ``ext`` (``External.calculate`` of
    the same seeded weights, a fresh list each call) at the same positions.
    Checks: each call's refined list holds a fresh list's pairs; energies
    within FWD_TOL and forces within BWD_TOL of External's (the same pairs
    on a list of another width: the skin list's K 113 against K 81 regroups
    the kernels' f32 slot sums, which may flip a bf16 rounding, and the
    forces come out of #2; how many calls are bitwise is printed); ``stale``
    False; launches per call (#1 and #2 L each, #6 once a
    rebuild); ms per call against External's; #1, #2 and #6 timed at its skin
    list and build.  Returns ((fwd, bwd, select_topk) launches, {kernel row:
    {"opt_dhfr": (ms, bound_ms)}})."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch import create_model, optimize
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    z, pos, _ = _synthetic_batch(ext.n_real, SEED, "cpu")
    model = create_model(ET_ARGS, seed=SEED)
    template = ext._template
    n, n_all = ext.n_real, template.num_atoms
    rng = np.random.default_rng(SEED)
    moves = [rng.normal(scale=OPT_STEP, size=pos.shape).astype(np.float32) for _ in range(OPT_CALLS)]
    inputs = []
    p = torch.as_tensor(pos, device="cuda")
    for m in moves:
        p = p + torch.as_tensor(m, device="cuda")
        inputs.append(torch.cat([p, p.new_zeros((n_all - n, 3))]))
    # the example's positions size the cell list (External's template holds zeros)
    opt = optimize(model, template.replace(pos=inputs[0]), skin=OPT_SKIN, rebuild_every=OPT_REBUILD_EVERY)
    _reset_launches()
    results, lists = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for full in inputs:
        y, f = opt(full)
        results.append((y, f))
        lists.append(opt._nbl)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / OPT_CALLS
    launches = (em.run_fwd.launches, em.run_bwd.launches, select_topk.launches)
    layers = ET_ARGS["num_layers"]
    rebuilds = -(-OPT_CALLS // OPT_REBUILD_EVERY)
    if launches != (layers * OPT_CALLS, layers * OPT_CALLS, rebuilds):
        raise AssertionError(f"optimize(): launches {launches}, expected ({layers * OPT_CALLS}, "
                             f"{layers * OPT_CALLS}, {rebuilds})")
    _check_et_parts("opt_dhfr", launches[1], 0)
    if opt.stale:
        raise AssertionError("optimize()'s skin list went stale")
    lo, hi = ET_ARGS["cutoff_lower"], ET_ARGS["cutoff_upper"]

    def pairs(nbl):
        rows = torch.arange(n_all, device="cuda")[:, None].expand_as(nbl.idx)
        return torch.sort((rows * n_all + nbl.idx.long())[nbl.mask]).values

    same_lists, bitwise, worst = 0, 0, (0.0, 0.0)
    for full, (y, f), nbl in zip(inputs, results, lists):
        refined = nbl.refine(full, lo, hi)
        at = template.replace(pos=full)
        fresh = model.neighbors(at, **probe_cell_kwargs(at, cutoff_upper=hi))
        fresh.raise_on_overflow("optimize()'s fresh list")
        a, b = pairs(refined), pairs(fresh)
        equal_pairs = a.shape == b.shape and bool(torch.equal(a, b))
        energy, forces = ext.calculate(full[:n])
        if not (y.shape == (1, 1) and f.shape == (n_all, 3) and torch.isfinite(y).all() and torch.isfinite(f).all()):
            raise AssertionError(f"optimize(): energies {tuple(y.shape)} and forces {tuple(f.shape)} not finite")
        same = bool(torch.equal(y.reshape(1), energy)) and bool(torch.equal(f[:n], forces[0]))
        e_err = float((y.reshape(1) - energy).abs().max() / energy.abs().max())
        f_err = float((f[:n] - forces[0]).abs().max() / forces[0].abs().max())
        worst = (max(worst[0], e_err), max(worst[1], f_err))
        same_lists += equal_pairs
        bitwise += same
        if not equal_pairs or e_err > FWD_TOL or f_err > BWD_TOL:
            raise AssertionError(f"optimize() against External: |dE|/|E| {e_err:.3e}, max|dF|/max|F| {f_err:.3e}, "
                                 f"the pairs {'equal' if equal_pairs else 'not equal'}")
    ext_ms = host_ms(lambda: ext.calculate(inputs[-1][:n]))
    # #1 and #2 (frozen weights) at the last call's refined skin list, #6 at
    # its build (L2 flushed, median of 20)
    knbl, ins, cts = _kernel_inputs(None, lists[-1].k, ET_ARGS["embedding_dimension"], ET_ARGS["num_rbf"], hi, SEED,
                                    batch=template.replace(pos=inputs[-1]), nbl=lists[-1].refine(inputs[-1], lo, hi))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
    common = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]
    kw = dict(heads=ET_ARGS["num_heads"], act="silu", attn_act="silu")
    nk, kk = knbl.idx.shape
    h, rbf = ET_ARGS["embedding_dimension"], ET_ARGS["num_rbf"]
    keys, k, _ = cell_keys(ET_ARGS, template.replace(pos=inputs[-1]), skin=OPT_SKIN)
    timed = {
        "et_message_fwd": (event_ms(lambda: em.run_fwd(knbl.idx, *common, dirs, *w, **kw), flush=flush),
                           _bounds(nk, kk, h, rbf, "fwd")[0]),
        "et_message_bwd": (event_ms(lambda: em.run_bwd(knbl.idx, knbl.transpose_perm, *common, dirs, *w, cts[0],
                                                        cts[1], want_weight_grads=False, **kw), flush=flush),
                           _bounds(nk, kk, h, rbf, "bwd")[0]),
        "select_topk": (event_ms(lambda: select_topk(keys, k, keys.shape[0]), flush=flush),
                        _select_topk_bounds(keys, k, keys.shape[0])[0]),
    }
    log(f"H3-OPT: optimize() serving ET {layers}x{ET_ARGS['embedding_dimension']} fused bf16 at DHFR size ({n} atoms "
        f"padded to {n_all}, skin {OPT_SKIN} A, a rebuild every {OPT_REBUILD_EVERY} calls, {OPT_CALLS} calls, seeded "
        f"steps of {OPT_STEP} A a coordinate): launches #1 {launches[0]} #2 {launches[1]} #6 {launches[2]} ({layers} "
        f"+ {layers} a call, one #6 a rebuild); stale False; the refined list held a fresh list's pairs in "
        f"{same_lists} of {OPT_CALLS} calls; against External.calculate at the same positions: bitwise in {bitwise} "
        f"of {OPT_CALLS} calls, largest |dE|/|E| {worst[0]:.3e} (tol {FWD_TOL}), max|dF|/max|F| {worst[1]:.3e} "
        f"(tol {BWD_TOL}); "
        f"{ms:.3f} ms a call (host clock with sync, mean of {OPT_CALLS}, rebuilds included) against External's "
        f"{ext_ms:.3f} ms (median of 20); at its skin list (N={nk} K={kk}) #1 {timed['et_message_fwd'][0]:.4f} ms "
        f"(bound {timed['et_message_fwd'][1]:.4f}), #2 frozen {timed['et_message_bwd'][0]:.4f} ms (bound "
        f"{timed['et_message_bwd'][1]:.4f}); #6 at its build (W={keys.shape[1]} k={k}) {timed['select_topk'][0]:.4f} "
        f"ms (bound {timed['select_topk'][1]:.4f})")
    del opt, model, results, lists, knbl, ins, cts, keys
    return launches, {name: {"opt_dhfr": at} for name, at in timed.items()}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 1
    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS, FACTOR_IX_ATOMS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from torchmdnet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    usage = [ln.strip() for out in logs.values() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    log(f"built {list(build.SOURCES)} for sm_90a in {seconds:.1f} s; ptxas: {' | '.join(usage)}")
    log_et_resources()
    log_t_resources()
    log_tn_resources()
    log_compaction_resources()

    check_kernels("medium", 512, 40, 64, 4, 32, 3.5, seed=1)
    fwd_abs, bwd_abs, _ = check_kernels("DHFR", 2489, 80, 128, 8, 50, 5.0, seed=2)
    train_ds = _train_dataset()
    a = TRAIN_ARGS
    _, _, bwd2_abs = check_kernels("training", None, a["max_num_neighbors"], a["embedding_dimension"],
                                   a["num_heads"], a["num_rbf"], a["cutoff_upper"], seed=4,
                                   batch=_train_batch(train_ds, "cuda"))
    tn_cfg = _train_cfg("tn")
    tn_ds = _train_dataset(TN_TRAIN_SPLIT)
    tn_batch = _train_batch(tn_ds, "cuda", TN_TRAIN_BATCH, TN_TRAIN_ARGS["cutoff_upper"])
    check_tn_kernels("medium, periodic box", "box", seed=1)
    tn_fwd_abs, tn_bwd_abs, _ = check_tn_kernels("DHFR", "DHFR", seed=2)
    _, _, tn_bwd2_abs = check_tn_kernels("training", tn_batch, seed=4)
    # the widths below 128 that the kernels take (their products split into
    # H/8 items), and 64 RBFs at 128 (#10's g_ea product in RBFP/8 items,
    # its tiles at 213 KB of shared memory), on 16 training molecules
    narrow_batch = _train_batch(tn_ds, "cuda", TN_NARROW_MOLECULES, TN_TRAIN_ARGS["cutoff_upper"])
    for h in TN_NARROW_WIDTHS:
        check_tn_kernels("narrow", narrow_batch, seed=5, h=h)
    check_tn_kernels("64 RBFs", narrow_batch, seed=6, rbf=TN_WIDE_RBF)
    del narrow_batch
    for influence in ("keys", "values", "none"):
        check_t_kernels("medium", 512, 40, 64, 4, 32, 3.5, seed=1, influence=influence)
    # 2H = 192: the weight reduction's partial last block of 128 columns
    check_t_kernels("narrow", 512, 40, 96, 3, 32, 3.5, seed=3)
    t_fwd_abs, t_bwd_abs, _ = check_t_kernels("DHFR", 2489, T_ARGS["max_num_neighbors"], 128, 8, 50, 5.0, seed=2)
    ta = T_TRAIN_ARGS
    _, _, t_bwd2_abs = check_t_kernels("training", None, ta["max_num_neighbors"], ta["embedding_dimension"],
                                       ta["num_heads"], ta["num_rbf"], ta["cutoff_upper"], seed=4,
                                       batch=_train_batch(train_ds, "cuda"))
    third_launches = third_derivative_probes()
    stmv = _stmv_batch()
    keys, k, _ = stmv_skin_keys(stmv)
    zbl_k = find_zbl_k()
    sel_cases, sel_label_of = select_cases(_synthetic_batch(DHFR_ATOMS, SEED, "cuda")[2], stmv, keys, k, zbl_k)
    log_select_topk_resources(sel_cases)
    sel_abs = check_select_topk(sel_cases)
    check_cell_vs_brute(DHFR_ATOMS)
    check_cell_vs_brute(FACTOR_IX_ATOMS)
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    t_model = create_model(T_ARGS, seed=SEED)
    dhfr_batch = _synthetic_batch(DHFR_ATOMS, SEED, "cuda")[2]
    train_batch_gpu = _train_batch(train_ds, "cuda")
    check_compaction("DHFR", dhfr_batch, T_ARGS["max_num_neighbors"], T_ARGS["cutoff_upper"], model=t_model)
    md_build = compaction_shapes()["MD build"]
    check_compaction("MD build", dhfr_batch, md_build["k"], md_build["cutoff_upper"], md_build["cutoff_lower"],
                     model=t_model, skin=MD_ARGS["neighbor_skin"])
    check_compaction("DHFR, int32 ids", dhfr_batch, T_ARGS["max_num_neighbors"], T_ARGS["cutoff_upper"],
                     ids=dhfr_batch.batch.int())
    check_compaction("training batch", train_batch_gpu, T_TRAIN_ARGS["max_num_neighbors"],
                     T_TRAIN_ARGS["cutoff_upper"])
    for label, case in COMPACTION_STAGE_CASES.items():
        stage_batch, stage_mask = _compaction_stage_batch(*case)
        check_compaction(label, stage_batch, COMPACTION_STAGE_K, T_ARGS["cutoff_upper"], atom_mask=stage_mask)
        check_compaction(f"{label}, int32 ids", stage_batch, COMPACTION_STAGE_K, T_ARGS["cutoff_upper"], 0.5,
                         atom_mask=stage_mask, ids=stage_batch.batch.int())
    del t_model, stage_batch, stage_mask
    gn_nbls = _gn_lists()
    log_ell_resources(gn_nbls)
    gn_errs = check_ell_gather(gn_nbls)
    ext_launches, ext, pos, _, _ = main_path(ET_ARGS, em, "ET 6x128 fused")
    opt_launches, opt_timed = opt_dhfr(ext)
    zbl_launches, zbl_prior_launches, zbl_ext, zbl_pos = zbl_path(zbl_k)
    tn_ext_launches, tn_ext, tn_pos, tn_call_ms, _ = main_path(TN_ARGS, tm, "TensorNet 2x128 fused")
    tn_strong_messages()
    gn_ext_launches, gn_ext, gn_pos, gn_call_ms, _ = main_path(GN_ARGS, _gn_km(), "GN 6x128")
    t_ext_launches, t_ext, t_pos, t_call_ms, t_share = main_path(T_ARGS, tmk, "Transformer 6x128 fused")
    t_strong_messages(t_share)
    dipole_launches, tn_dipole_launches, dipole_fwd, dipole_abs, dipole_call = dipole_path(train_ds, tn_batch)
    gn_fwd = gn_forward()
    times = time_kernels(seed=SEED)
    train_ms, train_plain, train_bounds = time_train_kernels(_train_batch(train_ds, "cuda"))
    tn_times = time_tn_kernels(tn_batch)
    gn_times = time_ell_gather(gn_nbls)
    sel_times = time_select_topk(sel_cases)
    sel_time = sel_times["STMV skin build"]
    t_times = time_t_kernels(_train_batch(train_ds, "cuda"))
    comp_times = time_compaction(dhfr_batch)
    del dhfr_batch, train_batch_gpu
    del keys, stmv, gn_nbls, sel_cases
    md_launches, sim, md_ms, md_peak = md_stmv(sel_time[0])
    remat_paths, remat_timed, tn_stmv_abs, remat_sims = remat_md_stmv((md_ms, md_peak))
    gn_md_launches, gn_sim, gn_md_ms, _ = gn_md_stmv()
    gn_remat_paths = gn_remat_md_stmv()
    t_md_launches, t_md_ms = t_md_brute_pallas()
    et_cfg = _train_cfg("et")
    gn_cfg = _train_cfg("gn")
    gn_ds = _train_dataset(GN_TRAIN_SPLIT, GN_TRAIN_MOL)
    remat_train = {"train_remat": train_grads_vs_composable(train_ds, et_cfg),
                   "tn_train_remat": train_grads_vs_composable(tn_ds, tn_cfg),
                   "gn_train_remat": train_grads_vs_composable(gn_ds, gn_cfg)}
    t_cfg = _train_cfg("t")
    remat_train["t_train_remat"] = train_grads_vs_composable(train_ds, t_cfg)
    with tempfile.TemporaryDirectory() as workdir:
        fgm_launches = force_grad_modes(train_ds, tn_ds, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        prior_train_launches, prior_trainer, prior_ds, prior_cfg = prior_training(workdir)
    prior_batch = _train_batch(prior_ds, "cuda", PRIOR_TRAIN_BATCH)
    prior_ms, _, prior_bounds = time_train_kernels(prior_batch, "the prior-training shapes")
    del prior_ds
    with tempfile.TemporaryDirectory() as workdir:
        trainer, train_launches = train_cli(workdir, et_cfg)
    with tempfile.TemporaryDirectory() as workdir:
        tn_trainer, tn_train_launches = train_cli(workdir, tn_cfg)
    with tempfile.TemporaryDirectory() as workdir:
        gn_trainer, gn_train_launches = train_cli(workdir, gn_cfg)
    with tempfile.TemporaryDirectory() as workdir:
        t_trainer, t_train_launches = train_cli(workdir, t_cfg)
    with tempfile.TemporaryDirectory() as workdir:
        md17_launches, md17_trainer, md17_batch, md17_best = md17_training(workdir)
        import_launches = import_serving(md17_best, workdir, md17_batch)
        native_collation(md17_trainer, workdir)
        jvp_cli_launches = md17_jvp_cli(workdir)
    ckpt_launches = jax_checkpoint_serving()
    # slice H3: the published SPICE and QM9 configurations through the CLI
    h3_paths, h3_runs = {}, {}
    for confs, split_of, sizes, frames, forces in ((SPICE_CONFS, SPICE_SPLITS, SPICE_SIZES, SPICE_FRAMES, True),
                                                   (QM9_CONFS, None, QM9_SIZES, QM9_FRAMES, False)):
        for family, conf in confs.items():
            with tempfile.TemporaryDirectory() as workdir:
                launches, h3_trainer, h3_batch = example_training(
                    workdir, conf, QM9_SPLIT if split_of is None else split_of[family], sizes, frames, forces)
            path = f"{conf[:-5].lower().replace('-', '_')}_train"
            prefix = "et" if family == "ET" else "tn"
            h3_paths[path] = dict(zip((f"{prefix}_message_fwd", f"{prefix}_message_bwd", f"{prefix}_message_bwd2",
                                       "select_topk"), launches))
            h3_runs[path] = (dict(h3_trainer.h), h3_batch)
            del h3_trainer
    sh, sb = h3_runs["et_spice_train"]
    h3_et_abs = check_kernels("ET-SPICE training", None, sh["max_num_neighbors"], sh["embedding_dimension"],
                              sh["num_heads"], sh["num_rbf"], sh["cutoff_upper"], seed=9, batch=sb)
    sh, sb = h3_runs["tensornet_spice_train"]
    h3_tn_abs = check_tn_kernels("TensorNet-SPICE training", sb, seed=10, h=sh["embedding_dimension"],
                                 rbf=sh["num_rbf"], k=sh["max_num_neighbors"], cutoff=sh["cutoff_upper"])
    h3_timed, _ = h3_kernel_times(*(h3_runs[p] for p in ("et_spice_train", "tensornet_spice_train", "et_qm9_train",
                                                          "tensornet_qm9_train")))
    log("H3: the published configurations no phase runs and the path that covers each: "
        + "; ".join(f"examples/{a}: {b}'s path" for a, b in COVERED_BY.items()))
    del h3_runs, sb
    # #1-#3 against their plain versions at the shapes these two paths run:
    # ET-MD17's training batch and its widths at DHFR size with K 80
    mh = md17_trainer.h
    md17_abs = check_kernels("ET-MD17 training", None, mh["max_num_neighbors"], mh["embedding_dimension"],
                             mh["num_heads"], mh["num_rbf"], mh["cutoff_upper"], seed=7, batch=md17_batch)
    md17_dhfr_abs = check_kernels("ET-MD17 widths at DHFR", DHFR_ATOMS, ET_ARGS["max_num_neighbors"],
                                  mh["embedding_dimension"], mh["num_heads"], mh["num_rbf"], mh["cutoff_upper"],
                                  seed=8)
    md17_ms, _, md17_bounds = time_train_kernels(md17_batch, "ET-MD17's training shapes", args=mh)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        dp_launches = dp_training(workdir)
    with tempfile.TemporaryDirectory() as workdir:
        ep_launches = edge_partition(workdir)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        ept_launches, ept_timed = edge_training(workdir)
    log(f"parallel-layer phases (G-DP, G-EP, G-MD, G-EPT): {time.perf_counter() - t0:.1f} s (G-EPT "
        f"{time.perf_counter() - t1:.1f} s)")
    train_batch, _ = time_train_steps(trainer, train_ds, et_cfg)
    tn_train_batch, tn_step_ms = time_train_steps(tn_trainer, tn_ds, tn_cfg)
    gn_train_batch, gn_step_ms = time_train_steps(gn_trainer, gn_ds, gn_cfg)
    t_train_batch, t_step_ms = time_train_steps(t_trainer, train_ds, t_cfg)
    # last: the profiler's tracing may slow what runs after it
    profiling_phase(ext, pos, sim)
    profile_calls(ext, pos, ET_SERVE_KERNELS, "fused ET")
    profile_calls(tn_ext, tn_pos, TN_SERVE_KERNELS, "fused TensorNet")
    profile_calls(gn_ext, gn_pos, GN_KERNELS, "GN")
    profile_calls(t_ext, t_pos, T_SERVE_KERNELS, "fused Transformer")
    profile_calls(zbl_ext, zbl_pos, ET_SERVE_KERNELS + ("select_topk_kernel",), "fused ET with a ZBL prior")
    wall, busy, groups, other, launches, _ = kernel_profile(dipole_call, 3, ("et_fwd_kernel",))
    log(f"profile of 3 ET dipole calls at ET-QM9's widths (torch.profiler): wall {wall:.3f} ms/call, device busy "
        f"{busy:.3f} ms/call ({100 * busy / wall:.1f}%); {_shares(groups, other, busy)} "
        f"({launches:.0f} other launches/call)")
    profile_md(sim)
    profile_md(remat_sims[0], label="ET with remat")
    profile_md(remat_sims[1], TN_SERVE_KERNELS, "TensorNet with remat")
    profile_md(gn_sim, GN_KERNELS, "GN", steps=2 * MD_VALID_EVERY)
    profile_train(trainer, train_batch, et_cfg)
    profile_train(tn_trainer, tn_train_batch, tn_cfg)
    profile_train(gn_trainer, gn_train_batch, gn_cfg)
    profile_train(t_trainer, t_train_batch, t_cfg)
    profile_train(prior_trainer, prior_batch, prior_cfg)
    profile_train(md17_trainer, md17_batch, dict(label="ET-MD17 6x128", kernels=MD17_KERNELS))
    log(f"TensorNet paths: DHFR energy+forces {tn_call_ms:.3f} ms/call, TensorNet-ANI1X training "
        f"{tn_step_ms:.3f} ms/step ({1e3 * TN_TRAIN_BATCH / tn_step_ms:.1f} molecules/s)")
    log(f"GN paths: DHFR energy+forces {gn_call_ms:.3f} ms/call (bf16 messages, K=80); forward "
        f"{gn_fwd['DHFR'][0]:.3f} ms at DHFR (f32, K=32) and {gn_fwd['STMV'][0]:.3f} ms at STMV (bf16, K=32) "
        f"against the reference's {REF_GN_FWD_MS['DHFR']} / {REF_GN_FWD_MS['STMV']} ms on a desktop NVIDIA GPU "
        f"(another card); STMV MD {gn_md_ms:.3f} ms/step; GN-aspirin training {gn_step_ms:.3f} ms/step "
        f"({1e3 * GN_TRAIN_BATCH / gn_step_ms:.1f} molecules/s)")
    log(f"Transformer paths: DHFR energy+forces {t_call_ms:.3f} ms/call; DHFR MD on brute-pallas "
        f"{t_md_ms:.3f} ms/step; training {t_step_ms:.3f} ms/step ({1e3 * TRAIN_BATCH / t_step_ms:.1f} molecules/s)")

    # launches: the counts of the main paths' runs (External at DHFR size for
    # ET and TensorNet, MD at STMV size, training through the CLI for ET and
    # TensorNet), each counted from 0 just before it ran
    paths = {
        "external_dhfr": dict(zip(("et_message_fwd", "et_message_bwd", "select_topk"), ext_launches)),
        "md_stmv": dict(zip(("et_message_fwd", "et_message_bwd", "select_topk"), md_launches)),
        "train": dict(zip(("et_message_fwd", "et_message_bwd", "et_message_bwd2", "select_topk"), train_launches)),
        "tn_external_dhfr": dict(zip(("tn_message_fwd", "tn_message_bwd", "select_topk"), tn_ext_launches)),
        "tn_train": dict(zip(("tn_message_fwd", "tn_message_bwd", "tn_message_bwd2", "select_topk"),
                             tn_train_launches)),
        "gn_external_dhfr": dict(zip(("ell_gather", "ell_transpose_sum", "select_topk"), gn_ext_launches)),
        "gn_forward_stmv": dict(zip(("ell_gather", "ell_transpose_sum", "select_topk"), gn_fwd["STMV"][1])),
        "gn_md_stmv": dict(zip(("ell_gather", "ell_transpose_sum", "select_topk"), gn_md_launches)),
        "gn_train": dict(zip(("ell_gather", "ell_transpose_sum"), gn_train_launches)),
        "t_external_dhfr": dict(zip(("t_message_fwd", "t_message_bwd", "select_topk"), t_ext_launches)),
        "t_train": dict(zip(("t_message_fwd", "t_message_bwd", "t_message_bwd2", "select_topk"), t_train_launches)),
        "t_md_brute_pallas": dict(zip(("t_message_fwd", "t_message_bwd", "compaction", "select_topk"),
                                      t_md_launches)),
        "zbl_external_dhfr": dict(zip(("et_message_fwd", "et_message_bwd", "select_topk"), zbl_launches)),
        "zbl_prior_dhfr": {"select_topk": zbl_prior_launches},
        "dipole_qm9": {"et_message_fwd": dipole_launches},
        "tn_dipole": {"tn_message_fwd": tn_dipole_launches},
        "prior_train": dict(zip(("et_message_fwd", "et_message_bwd", "et_message_bwd2", "select_topk"),
                                prior_train_launches)),
        "md17_train": dict(zip(("et_message_fwd", "et_message_bwd", "et_message_bwd2", "select_topk"),
                               md17_launches)),
        "import_external_dhfr": dict(zip(("et_message_fwd", "et_message_bwd", "select_topk"), import_launches)),
        "dp_nccl_train": dict(zip(("et_message_fwd", "et_message_bwd", "et_message_bwd2", "select_topk"),
                                  dp_launches)),
        # rank 0 of two edge-partitioned ranks: one DHFR call; 20 MD steps at DHFR
        "ep_dhfr": ep_launches["ep_dhfr"],
        "ep_md_dhfr": ep_launches["ep_md_dhfr"],
        # rank 0 of two edge-partitioned ranks: ET's CLI force training on DHFR
        # frames; one T and one TensorNet DHFR call; their training steps
        **ept_launches,
        # slice H1: one force-loss step by gradgrad and in jvp mode at the
        # training shapes (ET, T, TensorNet); a third derivative of each
        # family at the medium check shapes; ET-MD17's CLI in jvp mode; the
        # JAX package's checkpoint served fused through External
        **fgm_launches,
        **third_launches,
        **jvp_cli_launches,
        **ckpt_launches,
        # slice H2: bench.py's STMV MD lines under remat (ET and TensorNet at
        # bench.py's cadence); one force-loss gradient of each family with
        # remat at its training shapes
        **remat_paths,
        "train_remat": dict(zip(("et_message_fwd", "et_message_bwd", "et_message_bwd2"), remat_train["train_remat"])),
        "tn_train_remat": dict(zip(("tn_message_fwd", "tn_message_bwd", "tn_message_bwd2"),
                                   remat_train["tn_train_remat"])),
        "t_train_remat": dict(zip(("t_message_fwd", "t_message_bwd", "t_message_bwd2"), remat_train["t_train_remat"])),
        "gn_train_remat": dict(zip(("ell_gather", "ell_transpose_sum"), remat_train["gn_train_remat"][:2])),
        # slice H3: bench.py's GN STMV MD line with remat (its cadence and one
        # where the skin holds); examples' SPICE and QM9 files through the CLI;
        # optimize() serving ET at DHFR size
        **gn_remat_paths,
        **h3_paths,
        "opt_dhfr": dict(zip(("et_message_fwd", "et_message_bwd", "select_topk"), opt_launches)),
    }
    for path, parts in PART_LAUNCHES.items():
        paths[path].update(parts)
    gn_rows = {kind: (t["ms"], t["plain_ms"], t["bound_ms"], t["bound_by"], t["library_ms"])
               for kind, t in gn_times["DHFR"].items() if kind != "shape"}
    bwd2_row = (train_ms["bwd2"], train_plain["bwd2"]) + train_bounds["bwd2"] + (None,)
    t_rows = {k: t_times[(where, k)][:4] + (None,)
              for where, k in (("DHFR", "fwd"), ("DHFR", "bwd"), ("training", "bwd2"))}
    # (ms, bound) at the shape each path runs: MD at the STMV skin list,
    # training at the training shapes (the data-parallel NCCL run at ET-MD17's),
    # GN's STMV forward at its K = 32 list, the selection at each path's own
    # cell-list build; a path not named here (the edge-partitioned DHFR
    # paths: the DHFR row shape, each rank half its rows) runs its row's shape
    # and takes its row's (ms, bound_ms)
    gn_at = {where: {kind: (t["ms"], t["bound_ms"]) for kind, t in v.items() if kind != "shape"}
             for where, v in gn_times.items()}
    timed_at = {
        "et_message_fwd": {"md_stmv": times["stmv_fwd"], "train": (train_ms["fwd"], train_bounds["fwd"][0]),
                           "dipole_qm9": (dipole_fwd[0], dipole_fwd[2]),
                           "prior_train": (prior_ms["fwd"], prior_bounds["fwd"][0]),
                           "md17_train": (md17_ms["fwd"], md17_bounds["fwd"][0]),
                           "dp_nccl_train": (md17_ms["fwd"], md17_bounds["fwd"][0])},
        "et_message_bwd": {"md_stmv": times["stmv_bwd"], "train": (train_ms["bwd_w"], train_bounds["bwd_w"][0]),
                           "prior_train": (prior_ms["bwd_w"], prior_bounds["bwd_w"][0]),
                           "md17_train": (md17_ms["bwd_w"], md17_bounds["bwd_w"][0]),
                           "dp_nccl_train": (md17_ms["bwd_w"], md17_bounds["bwd_w"][0])},
        "et_message_bwd2": {"prior_train": (prior_ms["bwd2"], prior_bounds["bwd2"][0]),
                            "md17_train": (md17_ms["bwd2"], md17_bounds["bwd2"][0]),
                            "dp_nccl_train": (md17_ms["bwd2"], md17_bounds["bwd2"][0])},
        "tn_message_fwd": {"tn_train": tn_times[("training", "fwd")][::2][:2],
                           "tn_dipole": tn_times[("training", "fwd")][::2][:2]},
        "tn_message_bwd": {"tn_train": tn_times[("training", "bwd_w")][::2][:2]},
        "t_message_fwd": {"t_train": t_times[("training", "fwd")][::2][:2]},
        "t_message_bwd": {"t_train": t_times[("training", "bwd_w")][::2][:2]},
        "ell_gather": {"gn_forward_stmv": gn_at["STMV forward"]["gather"], "gn_md_stmv": gn_at["STMV skin"]["gather"],
                       "gn_train": gn_at["training"]["gather"]},
        "ell_transpose_sum": {"gn_md_stmv": gn_at["STMV skin"]["transpose"],
                              "gn_train": gn_at["training"]["transpose"]},
        "select_topk": {path: sel_times[label][::2][:2] for path, label in sel_label_of.items()},
        "compaction": {"t_md_brute_pallas": (comp_times["MD build"]["ms"], comp_times["MD build"]["bound_ms"])},
    }
    for name, at in ept_timed.items():  # the G-EPT paths at rank 0's shape
        timed_at.setdefault(name, {}).update(at)
    # H-FGM's steps at the training shapes, H-CLI's at ET-MD17's
    for mode in ("gradgrad", "jvp"):
        for row, at in (("et_message_fwd", (train_ms["fwd"], train_bounds["fwd"][0])),
                        ("et_message_bwd", (train_ms["bwd_w"], train_bounds["bwd_w"][0])),
                        ("et_message_bwd2", (train_ms["bwd2"], train_bounds["bwd2"][0])),
                        ("t_message_fwd", t_times[("training", "fwd")][::2][:2]),
                        ("t_message_bwd", t_times[("training", "bwd_w")][::2][:2]),
                        ("t_message_bwd2", t_times[("training", "bwd2")][::2][:2]),
                        ("tn_message_fwd", tn_times[("training", "fwd")][::2][:2]),
                        ("tn_message_bwd", tn_times[("training", "bwd_w")][::2][:2]),
                        ("tn_message_bwd2", tn_times[("training", "bwd2")][::2][:2])):
            timed_at.setdefault(row, {})[f"fgm_{row.split('_')[0]}_{mode}"] = at
    timed_at["et_message_fwd"]["md17_jvp_train"] = (md17_ms["fwd"], md17_bounds["fwd"][0])
    # H2-REMAT: ET's MD at the STMV skin list and #6 at its skin build,
    # TensorNet's at its own (remat_md_stmv), the remat gradients at the
    # training shapes
    timed_at["et_message_fwd"]["md_stmv_remat"] = times["stmv_fwd"]
    timed_at["et_message_bwd"]["md_stmv_remat"] = times["stmv_bwd"]
    timed_at["select_topk"]["md_stmv_remat"] = sel_times["STMV skin build"][::2][:2]
    for name, at in remat_timed.items():
        timed_at.setdefault(name, {}).update(at)
    for row, path in (("et_message_fwd", "train"), ("et_message_bwd", "train"), ("t_message_fwd", "t_train"),
                      ("t_message_bwd", "t_train"), ("tn_message_fwd", "tn_train"), ("tn_message_bwd", "tn_train"),
                      ("ell_gather", "gn_train"), ("ell_transpose_sum", "gn_train")):
        timed_at[row][path.replace("train", "train_remat")] = timed_at[row][path]
    timed_at["et_message_bwd2"]["train_remat"] = (train_ms["bwd2"], train_bounds["bwd2"][0])
    timed_at["t_message_bwd2"]["t_train_remat"] = t_times[("training", "bwd2")][::2][:2]
    timed_at["tn_message_bwd2"]["tn_train_remat"] = tn_times[("training", "bwd2")][::2][:2]
    timed_at["et_message_bwd"]["md17_jvp_train"] = (md17_ms["bwd_w"], md17_bounds["bwd_w"][0])
    # H3: the example trainings at their training batches, optimize() at its
    # skin list and build, GN's remat MD at the STMV skin list and build
    for name, at in list(h3_timed.items()) + list(opt_timed.items()):
        timed_at.setdefault(name, {}).update(at)
    for path in gn_remat_paths:
        timed_at["ell_gather"][path] = gn_at["STMV skin"]["gather"]
        timed_at["ell_transpose_sum"][path] = gn_at["STMV skin"]["transpose"]
        timed_at["select_topk"][path] = sel_times["STMV skin build"][::2][:2]
    # #4's and #5's three times (event window, device alone, host enqueue)
    # beside their library call's, at each shape a GN path runs them
    by_shape = {name: {"times_by_shape": {where: {key: val for key, val in v[kind].items() if key != "bound_by"}
                                          for where, v in gn_times.items() if kind in v}}
                for name, kind in (("ell_gather", "gather"), ("ell_transpose_sum", "transpose"))}
    # #7's: the kernel's and the whole build's, at the DHFR row shape and the
    # MD build's
    by_shape["compaction"] = {"times_by_shape": comp_times}
    comp_row = tuple(comp_times["DHFR"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))
    kernels = []
    for name, source, line, (ms, plain_ms, bound_ms, bound_by, lib_ms), err in (
        ("et_message_fwd", "et_message.cu", "et_message.py:227", times["fwd"] + (None,),
         max(fwd_abs, times["stmv_abs"][0], dipole_abs, md17_abs[0], md17_dhfr_abs[0], h3_et_abs[0])),
        ("et_message_bwd", "et_message.cu", "et_message.py:296", times["bwd"] + (None,),
         max(bwd_abs, times["stmv_abs"][1], md17_abs[1], md17_dhfr_abs[1], h3_et_abs[1])),
        ("et_message_bwd2", "et_message.cu", "et_message.py:685", bwd2_row,
         max(bwd2_abs, md17_abs[2], md17_dhfr_abs[2], h3_et_abs[2])),
        ("select_topk", "select_topk.cu", "select_topk.py:32", sel_time, sel_abs),
        ("tn_message_fwd", "tn_message.cu", "tn_message.py:77", tn_times[("DHFR", "fwd")][:4] + (None,),
         max(tn_fwd_abs, tn_stmv_abs[0], h3_tn_abs[0])),
        ("tn_message_bwd", "tn_message.cu", "tn_message.py:107", tn_times[("DHFR", "bwd")][:4] + (None,),
         max(tn_bwd_abs, tn_stmv_abs[1], h3_tn_abs[1])),
        ("tn_message_bwd2", "tn_message.cu", "tn_message.py:455", tn_times[("training", "bwd2")][:4] + (None,),
         max(tn_bwd2_abs, h3_tn_abs[2])),
        ("ell_gather", "ell_gather.cu", "onehot_gather.py:178", gn_rows["gather"], gn_errs[0]),
        ("ell_transpose_sum", "ell_gather.cu", "onehot_gather.py:227", gn_rows["transpose"], gn_errs[1]),
        ("compaction", "compaction.cu", "compaction.py:31", comp_row, 0.0),
        ("t_message_fwd", "t_message.cu", "t_message.py:66", t_rows["fwd"], t_fwd_abs),
        ("t_message_bwd", "t_message.cu", "t_message.py:113", t_rows["bwd"], t_bwd_abs),
        ("t_message_bwd2", "t_message.cu", "t_message.py:519", t_rows["bwd2"], t_bwd2_abs),
    ):
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        # the helper kernels a row's kernel launches with it (the ET and
        # Transformer backward's and second order's source passes and weight
        # reduction)
        helpers = {"et_message_bwd": ("et_message_bwd_src", "et_message_dw"),
                   "et_message_bwd2": ("et_message_bwd2_src", "et_message_dw"),
                   "tn_message_bwd": ("tn_message_dw",),
                   "tn_message_bwd2": ("tn_message_dw",),
                   "t_message_bwd": ("t_message_bwd_src", "t_message_dw"),
                   "t_message_bwd2": ("t_message_bwd2_src", "t_message_dw")}.get(name, ())
        # the redesign queue's order (ROADMAP.md): the device time this run's
        # launches spent above the bound, each path's at its own timed shape;
        # null where this run timed no launch at the path's shape (H-3's
        # probes at the medium check shapes, the served JAX checkpoint's
        # molecules, the bf16 gathers of the jvp steps' composable tangents)
        at = {path: timed_at.get(name, {}).get(path, None if _untimed(name, path) else (ms, bound_ms))
              for path in by_path}
        excess = {path: None if at[path] is None else n * (at[path][0] - at[path][1])
                  for path, n in by_path.items() if n}
        kernels.append(dict(
            helper_launches={h: sum(c.get(h, 0) for c in paths.values()) for h in helpers},
            name=name, route="cuda", source=f"torchmdnet_tpu_torch/csrc/{source}",
            replaces=f"torchmdnet_tpu/ops/pallas/{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms,
            ms_by_path={path: None if at[path] is None else at[path][0] for path in excess},
            excess_by_path=excess, excess_ms=sum(v for v in excess.values() if v is not None),
            **by_shape.get(name, {}),
        ))
        if max(by_path.values()) < 1:
            raise AssertionError(f"{name} was not launched on a main path")
    gaps = sorted(((b[0] - a[0], b[1]) for a, b in zip(_LINE_TIMES, _LINE_TIMES[1:])), reverse=True)
    log(f"run time {_LINE_TIMES[-1][0] - _LINE_TIMES[0][0]:.1f} s from the first line; the stretches of 3 s or "
        "more, each ended by the line it names: " + "; ".join(f"{t:.1f} s to '{name}'" for t, name in gaps if t >= 3))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
