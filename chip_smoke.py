#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchmdnet_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the port's main paths: ET energy and forces for a DHFR-sized system
through ``External.calculate`` (whose neighbor list now comes from the cell
list and the selection kernel), the cell list against the brute search,
ET molecular dynamics at STMV size through ``md.Simulation`` (Verlet skin,
a cell-list rebuild every 10 steps), and force-loss training of the training
benchmark's ET (8 x 256) through the training CLI
(``torchmdnet_tpu_torch.scripts.train.main``), whose second-order pass runs
the second-order kernel.  It times each.  Each phase prints one line; the
line before the last is a JSON object with each kernel's numbers, the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Without a CUDA device, or outside a checkout, it exits non-zero
and prints no result.  It takes two to three minutes on an H100.
"""

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

# ET configuration of the serving benchmark (benchmarks/inference.py:31-55
# with the fused edge phase, as bench.py's et_fused_forces_dhfr2489_ms line)
ET_ARGS = dict(
    model="equivariant-transformer", embedding_dimension=128, num_layers=6, num_rbf=50,
    rbf_type="expnorm", trainable_rbf=True, activation="silu", attn_activation="silu",
    neighbor_embedding=True, num_heads=8, distance_influence="both", cutoff_lower=0.0,
    cutoff_upper=5.0, max_z=128, max_num_neighbors=80, derivative=True,
    output_model="Scalar", prior_model=None, reduce_op="add", precision=32,
    atom_filter=-1, bf16_messages=True, fused_attention=True,
)
REQUESTS = 5
SEED = 0

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

# ET configuration of the training benchmark (benchmarks/training.py:24-31,
# 91-124): 8 x 256, 8 heads, 64 ExpNormal RBFs (not trainable), cutoff 0-5 A,
# max_num_neighbors 32, NeighborEmbedding, Scalar head, the fused bf16 edge
# phase, energy and force loss (gradgrad), AdamW at lr 1e-4, batches of 128
# molecules of 18 atoms
TRAIN_ARGS = dict(
    model="equivariant-transformer", embedding_dimension=256, num_layers=8, num_rbf=64,
    rbf_type="expnorm", trainable_rbf=False, activation="silu", attn_activation="silu",
    neighbor_embedding=True, num_heads=8, distance_influence="both", cutoff_lower=0.0,
    cutoff_upper=5.0, max_z=100, max_num_neighbors=32, derivative=True,
    output_model="Scalar", prior_model=None, reduce_op="add", precision=32,
    atom_filter=-1, bf16_messages=True, fused_attention=True,
)
TRAIN_BATCH = 128
# SyntheticMorse molecules of 18 atoms in a 6 A cell keep the 2 A spacing
# that the 8-atom default has in its 4 A cell
TRAIN_MOL = dict(num_atoms=18, cell=6.0)
TRAIN_SPLIT = (1536, 128, 128)  # 12 training batches, one val, one test
TRAIN_EPOCHS = 2
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 20

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12
# int32 compare/select/min outside the tensor cores: the f32 peak counts an
# FMA as two operations on 128 f32 lanes per SM; an SM has 64 int32 lanes,
# one operation each, so a quarter of it
INT32_CUDA_CORE_OPS = F32_CUDA_CORE_FLOPS / 4

# STMV molecular dynamics as bench.py's stmv_md_ms configures it
# (bench.py:397-473): Verlet skin 0.5 A, a rebuild every 10 steps, Langevin
# at 300 K, spatially sorted atoms
MD_ARGS = dict(timestep_fs=1.0, temperature_K=300.0, friction_per_fs=0.01,
               neighbor_skin=0.5, rebuild_every=10)
MD_WARMUP_STEPS = 10
MD_TIMED_STEPS = 20
# a rebuild cadence at which the skin holds: at 300 K the fastest of 30,000
# atoms (hydrogens) start near 0.075 A/fs, so thermal motion alone carries
# them about 0.75 A in bench.py's 10 fs, three times skin/2, whatever the
# potential; in 2 fs about 0.15 A
MD_VALID_EVERY = 2
MD_VALID_STEPS = 10
# cutoff-boundary pairs between the brute search (|xi|^2 + |xj|^2 - 2 xi.xj)
# and the cell list (component form) may differ where d^2 is within this many
# f32 ulps of the cutoff^2: the two forms round differently
BOUNDARY_ULPS = 4


def log(line):
    print(line, flush=True)


def _synthetic_batch(n_atoms, seed, device):
    from torchmdnet_tpu_torch.data.batch import pad_molecules
    from torchmdnet_tpu_torch.data.systems import synthetic_system

    z, pos = synthetic_system(n_atoms, seed=seed)
    padded = -(-n_atoms // 32) * 32
    return z, pos, pad_molecules([{"z": z, "pos": pos}], num_atoms=padded, device=device)


def _kernel_inputs(n_atoms, k, h, rbf, cutoff, seed, batch=None):
    """Edge-phase operands on the card: a real ELL list of a synthetic
    system (or of ``batch``, a batch of small molecules: brute search, as
    ``Potential.neighbors`` takes for it), its geometry and RBFs, random bf16
    features and filters."""
    import torch

    from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
    from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, neighbor_list
    from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing

    dev = torch.device("cuda")
    strategy = "auto"
    if batch is None:
        _, _, batch = _synthetic_batch(n_atoms, seed, dev)
    else:
        strategy = "brute"
    nbl = neighbor_list(batch.pos, batch.batch, batch.atom_mask, k=k, cutoff_upper=cutoff, loop=True,
                        strategy=strategy)
    nbl.raise_on_overflow("chip_smoke kernel inputs")
    n, kk = nbl.idx.shape
    (dx, dy, dz), dist = edge_geometry_components(batch.pos, nbl)
    inv = (dist > 0).float() / torch.where(dist > 0, dist, torch.ones_like(dist))
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    ins = dict(
        q=rnd(n, h).to(bf), k=rnd(n, h).to(bf), v=rnd(n, 3 * h).to(bf),
        vec0=rnd(n, h).to(bf), vec1=rnd(n, h).to(bf), vec2=rnd(n, h).to(bf),
        ea=ExpNormalSmearing(0.0, cutoff, rbf).to(dev)(dist).detach().to(bf),
        cutm=(cosine_cutoff(dist, 0.0, cutoff) * nbl.mask).float(),
        msk=nbl.mask.float(),
        dir0=(dx * inv).float(), dir1=(dy * inv).float(), dir2=(dz * inv).float(),
        wdk=rnd(rbf, h, scale=rbf ** -0.5).to(bf), bdk=rnd(1, h, scale=0.1).to(bf),
        wdv=rnd(rbf, 3 * h, scale=rbf ** -0.5).to(bf), bdv=rnd(1, 3 * h, scale=0.1).to(bf),
    )
    cts = (rnd(n, h), rnd(n, 3 * h))
    return nbl, ins, cts


ORDER = ["q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk",
         "dir0", "dir1", "dir2", "wdk", "bdk", "wdv", "bdv"]


def _call(fn, nbl, ins, heads):
    return fn(nbl.idx, *[ins[n] for n in ORDER], heads=heads, perm=nbl.transpose_perm)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def _fmt(d):
    return json.dumps({a: float(f"{b:.3e}") for a, b in d.items()})


def _z_like(ins, seed):
    """Random cotangents Z on the backward's 16 outputs (none on msk's), in
    their dtypes: the second-order kernel's third operand."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [None if n == "msk" else (torch.randn(ins[n].shape, generator=g) * 0.5).to("cuda", ins[n].dtype)
            for n in ORDER]


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
    order's 16 + 2 gradients; a third derivative must raise."""
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
    # a second derivative runs the second-order kernel; keeping its graph
    # (the way to a third derivative) must raise
    t = {n: v.clone().requires_grad_(n in ("q", "k")) for n, v in ins.items()}
    x, _ = _call(em.fused_et_messages, nbl, t, heads)
    (g,) = torch.autograd.grad((x * x).sum(), t["q"], create_graph=True)
    try:
        torch.autograd.grad((g * g).sum(), t["k"], create_graph=True)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("a third derivative through the fused kernels did not raise")
    fwd = {nm: _rel(a, b) for nm, a, b in zip(("x_agg", "vec_agg"), outs["kernel"], outs["plain"])}
    bwd = {nm: _rel(grads["kernel"][nm], grads["plain"][nm]) for nm in ORDER}
    fwd_abs = max(float((a - b).abs().max()) for a, b in zip(outs["kernel"], outs["plain"]))
    bwd_abs = max(float((grads["kernel"][n].float() - grads["plain"][n].float()).abs().max()) for n in ORDER)
    n, kk = nbl.idx.shape
    log(f"kernel check {label} (N={n} K={kk} H={h} heads={heads} RBF={rbf}): "
        f"fwd max rel err {max(fwd.values()):.3e} (tol {FWD_TOL}) {_fmt(fwd)}; "
        f"bwd max rel err {max(bwd.values()):.3e} (tol {BWD_TOL}) {_fmt(bwd)}; "
        f"bwd2 max rel err {max(bwd2.values()):.3e} (tol {BWD2_TOL}) {_fmt(bwd2)}; "
        f"a third derivative raises")
    if max(fwd.values()) > FWD_TOL:
        raise AssertionError(f"forward kernel disagrees with the plain version at {label}: {fwd}")
    if max(bwd.values()) > BWD_TOL:
        raise AssertionError(f"backward kernel disagrees with the plain version at {label}: {bwd}")
    if max(bwd2.values()) > BWD2_TOL:
        raise AssertionError(f"second-order kernel disagrees with the plain version at {label}: {bwd2}")
    return fwd_abs, bwd_abs, bwd2_abs


def _event_ms(fn, reps=20, warmup=3, flush=None):
    """Median over ``reps`` launches of CUDA-event time, L2 flushed between."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, reps=20, warmup=3):
    """Median over ``reps`` calls of host-clock time, each ended by a sync."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


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


def time_kernels(seed):
    """Each kernel's time at the DHFR shapes, its plain version's, its bound."""
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
    fwd_ms = _event_ms(lambda: em.run_fwd(nbl.idx, *common, dirs, *w, **kw), flush=flush)
    bwd_ms = _event_ms(lambda: em.run_bwd(
        nbl.idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=False, **kw), flush=flush)
    bwd_w_ms = _event_ms(lambda: em.run_bwd(
        nbl.idx, perm, *common, dirs, *w, cts[0], cts[1], want_weight_grads=True, **kw), flush=flush)
    plain_fwd_ms = _event_ms(lambda: _call(em.et_messages_reference, nbl, ins, heads), flush=flush)
    t = {n: v.clone().requires_grad_(n in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "dir0", "dir1", "dir2"))
         for n, v in ins.items()}
    x, vec = _call(em.et_messages_reference, nbl, t, heads)
    leaves = [v for v in t.values() if v.requires_grad]
    plain_bwd_ms = _event_ms(
        lambda: torch.autograd.grad((x, vec), leaves, cts, retain_graph=True), flush=flush)
    fb, fby = _bounds(n, kk, 128, 50, "fwd")
    bb, bby = _bounds(n, kk, 128, 50, "bwd")
    bwb, bwby = _bounds(n, kk, 128, 50, "bwd_w")
    log(f"kernel times at DHFR shapes (N={n} K={kk} H=128 RBF=50, L2 flushed, median of 20): "
        f"fwd {fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f} ms, bound {fb:.4f} ms by {fby}); "
        f"bwd {bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f} ms, bound {bb:.4f} ms by {bby}); "
        f"bwd with weight cotangents {bwd_w_ms:.4f} ms (bound {bwb:.4f} ms by {bwby})")
    return dict(fwd=(fwd_ms, plain_fwd_ms, fb, fby), bwd=(bwd_ms, plain_bwd_ms, bb, bby))


def main_path():
    """ET energy + forces for the DHFR-sized system through External.calculate."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch import External, create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    z, pos, _ = _synthetic_batch(DHFR_ATOMS, SEED, "cpu")
    potential = create_model(ET_ARGS, seed=SEED)  # on cuda: no device named
    ext = External((potential, None), z[None])
    rng = np.random.default_rng(SEED)
    requests = [pos + rng.normal(scale=0.02, size=pos.shape).astype(np.float32) for _ in range(REQUESTS - 1)]
    requests.append(requests[-1].copy())  # the last request repeats the one before

    em.reset_launch_counts()
    select_topk.launches = 0
    results = []
    for p in requests:
        energy, forces = ext.calculate(p)
        results.append((energy.clone(), forces.clone()))
    torch.cuda.synchronize()
    launches = (em.run_fwd.launches, em.run_bwd.launches, select_topk.launches)
    layers = ET_ARGS["num_layers"]
    for energy, forces in results:
        if energy.shape != (1,) or forces.shape != (1, DHFR_ATOMS, 3):
            raise AssertionError(f"unexpected shapes {tuple(energy.shape)}, {tuple(forces.shape)}")
        if not (torch.isfinite(energy).all() and torch.isfinite(forces).all()):
            raise AssertionError("non-finite energy or forces")
    # one cell-list build per request, one more for the first request's capacity check
    if launches != (layers * REQUESTS, layers * REQUESTS, REQUESTS + 1):
        raise AssertionError(f"expected {layers} fwd + {layers} bwd launches per request and "
                             f"{REQUESTS + 1} select_topk launches, got {launches}")
    if not torch.equal(results[-1][1], results[-2][1]):
        raise AssertionError("forces of two identical requests differ")

    # the same weights through the composable fp32 path
    ref = create_model(dict(ET_ARGS, bf16_messages=False, fused_attention=False), seed=SEED)
    ref.module.load_state_dict(potential.module.state_dict())
    ref_ext = External((ref, None), z[None])
    e32, f32 = ref_ext.calculate(requests[0])
    e_err = float((results[0][0] - e32).abs().max() / e32.abs().max())
    f_err = float((results[0][1] - f32).abs().max() / f32.abs().max())
    f_l2 = float((results[0][1] - f32).norm() / f32.norm())
    log(f"main path: {REQUESTS} requests, ET 6x128 fused bf16, {DHFR_ATOMS} atoms (padded to "
        f"{ext.n_real + ext.n_pad}); launches fwd {launches[0]} bwd {launches[1]} "
        f"({layers}+{layers} per request), select_topk {launches[2]}; energies {[round(float(r[0][0]), 4) for r in results]}; "
        f"repeat forces bitwise equal: True; vs composable fp32: |dE|/|E| {e_err:.3e} (tol {E2E_ENERGY_TOL}), "
        f"max|dF|/max|F| {f_err:.3e} (tol {E2E_FORCE_TOL}), |dF|/|F| {f_l2:.3e}")
    if e_err > E2E_ENERGY_TOL or f_err > E2E_FORCE_TOL:
        raise AssertionError("fused energies/forces disagree with the composable fp32 path")

    fused_ms = _host_ms(lambda: ext.calculate(requests[0]))
    comp_ms = _host_ms(lambda: ref_ext.calculate(requests[0]))
    log(f"energy+forces per call (External.calculate, host clock with sync, median of 20): "
        f"fused bf16 {fused_ms:.3f} ms; composable fp32 {comp_ms:.3f} ms")
    return launches, ext, requests[0]


def profile_calls(ext, pos, calls=3):
    """Where the time of a fused energy+forces call goes: device time by
    kernel (torch.profiler's CUDA activity) against the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            ext.calculate(pos)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / calls
    groups = {"et_fwd_kernel": 0.0, "et_bwd_kernel": 0.0, "ell_transpose_sum_kernel": 0.0}
    other, launches = 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.device_time / 1e3 / calls
        key = next((k for k in groups if k in ev.name), None)
        if key is None:
            other += ms
            launches += 1
        else:
            groups[key] += ms
    busy = sum(groups.values()) + other
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    log(f"profile of {calls} fused calls (torch.profiler): wall {wall:.3f} ms/call, device busy "
        f"{busy:.3f} ms/call ({100 * busy / wall:.1f}%); et_fwd {groups['et_fwd_kernel']:.3f}, "
        f"et_bwd {groups['et_bwd_kernel']:.3f}, transpose-sum {groups['ell_transpose_sum_kernel']:.3f}, "
        f"other kernels {other:.3f} ms/call ({launches / calls:.0f} launches/call)")


def _stmv_batch():
    """Synthetic STMV (seed 0), padded to a multiple of 32, spatially sorted,
    on the card: the batch of bench.py's STMV MD (bench.py:420-425)."""
    from torchmdnet_tpu_torch.data.batch import spatial_sort
    from torchmdnet_tpu_torch.data.systems import STMV_ATOMS

    _, _, batch = _synthetic_batch(STMV_ATOMS, SEED, "cuda")
    return spatial_sort(batch)[0]


def stmv_skin_keys(batch):
    """The selection kernel's input at an STMV skin rebuild: the candidate
    key matrix of the cell list with the probed sizes ``md.Simulation``
    uses, and the skin list's k (``Potential.neighbors``' rule)."""
    from torchmdnet_tpu_torch.ops.cell_list import cell_candidate_keys, probe_cell_kwargs

    skin = MD_ARGS["neighbor_skin"]
    hi = ET_ARGS["cutoff_upper"]
    sizes = probe_cell_kwargs(batch, cutoff_upper=hi + skin)
    keys, _, overflow = cell_candidate_keys(
        batch.pos, batch.batch, batch.atom_mask, cutoff_upper=hi + skin, **sizes)
    if bool(overflow):
        raise AssertionError(f"the STMV skin build overflowed its probed cell sizes {sizes}")
    k = int(math.ceil(ET_ARGS["max_num_neighbors"] * ((hi + skin) / hi) ** 3 / 8.0)) * 8
    return keys, k, sizes


def _unique_keys(rng, n, w, sentinel, invalid_share):
    """(n, w) int32 keys, unique per row below ``sentinel``, a share of them
    replaced by the sentinel."""
    import numpy as np

    keys = np.argsort(rng.random((n, sentinel)), axis=1)[:, :w].astype(np.int32)
    keys[rng.random((n, w)) < invalid_share] = sentinel
    return keys


def check_select_topk(keys, k):
    """Kernel #6 against its plain version, one case for each keys-per-lane
    variant the kernel compiles: a ragged case (W not a multiple of 32, N not
    a multiple of the rows per block, rows with fewer real keys than k, an
    all-sentinel row), the DHFR build's keys (External's list, default cell
    capacity), the STMV skin build's keys, a capacity of up to 75 and a row
    wider than the register budget.  Integers: bitwise equal."""
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
    cases = [("ragged", torch.as_tensor(ragged, device="cuda"), 20, 5000),
             ("DHFR build", dhfr_keys, ET_ARGS["max_num_neighbors"], dhfr_keys.shape[0]),
             ("STMV skin build", keys, k, keys.shape[0]),
             ("capacity 66", torch.as_tensor(cap66, device="cuda"), 112, 5000),
             ("wide", torch.as_tensor(wide, device="cuda"), 50, 5000)]
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
        strategy: _host_ms(lambda: neighbor_list(batch.pos, batch.batch, batch.atom_mask, strategy=strategy, **kw))
        for strategy in ("brute", "cell")
    }
    log(f"cell list vs brute at {n_atoms} atoms (N={n}, K={cell.k}, cutoff {cut}): idx, mask, n_neighbors "
        f"equal; {diff.shape[0] // 2} cutoff-boundary pairs differ (within {BOUNDARY_ULPS} ulps of "
        f"cutoff^2), {int(touched.sum())} rows touched; cell_overflow False; build time (host clock "
        f"with sync, median of 20) brute {build_ms['brute']:.3f} ms, cell {build_ms['cell']:.3f} ms")


def _select_topk_bounds(keys, k):
    """Least time for the selection: max(bytes / HBM rate, operations / int32
    peak).  Bytes: the keys read once, the output written once.  Operations:
    what the function needs, one per key (a radix select, or a merge of the
    cells' already-ascending runs, looks at each key a bounded number of
    times).  Also returns what this kernel's design does, as a note: one
    compare/select and one min per key for each pass this data needs (a pass
    per real key of the row up to k, plus the pass that finds the sentinel
    when a row has fewer than k), at the int32 peak."""
    n, w = keys.shape
    passes = int(((keys < n).sum(dim=1) + 1).clamp(max=k).sum())
    t_bytes = (4 * n * w + 4 * n * k) / HBM_BYTES_PER_S
    t_ops = n * w / INT32_CUDA_CORE_OPS
    design_ops = 2 * passes * w
    bound = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return bound + (design_ops, 1e3 * design_ops / INT32_CUDA_CORE_OPS)


def time_select_topk(keys, k):
    """Kernel #6 at the STMV skin shapes: its time, the plain version's, one
    torch.topk call's, and the bound (L2 flushed, median of 20)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk, select_topk_reference

    n = keys.shape[0]
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    ms = _event_ms(lambda: select_topk(keys, k, n), flush=flush)
    plain_ms = _event_ms(lambda: select_topk_reference(keys, k), flush=flush)
    lib_ms = _event_ms(lambda: torch.topk(keys, k, dim=1, largest=False, sorted=True), flush=flush)
    bound_ms, bound_by, design_ops, design_ms = _select_topk_bounds(keys, k)
    log(f"select_topk time at the STMV skin shapes (N={n} W={keys.shape[1]} k={k}, L2 flushed, "
        f"median of 20): {ms:.4f} ms (plain sort {plain_ms:.4f} ms, torch.topk {lib_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.1f}% of it reached); this "
        f"design's min-extraction passes do {design_ops:.3e} int32 operations, {design_ms:.4f} ms "
        f"at the int32 peak")
    return ms, plain_ms, bound_ms, bound_by, lib_ms


def _pairs_against_fresh(sim, model, batch, built_at):
    """The skin list built at ``built_at`` and refined at ``sim``'s current
    positions against a fresh list built there, as sets of (atom, neighbor)
    pairs: (pairs only the fresh list holds, pairs only the refined list
    holds, the fresh list's pairs)."""
    import torch

    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    hi = ET_ARGS["cutoff_upper"]
    pos = sim.state.pos
    n = batch.num_atoms
    skin_nbl = sim._build_nbl(built_at)
    refined = skin_nbl.refine(pos, ET_ARGS["cutoff_lower"], hi)
    fresh = model.neighbors(batch.replace(pos=pos), k=skin_nbl.k - 1, **probe_cell_kwargs(batch, cutoff_upper=hi))
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

    rebuild_ms = _host_ms(lambda: sim._build_nbl(state.pos).transpose_perm, reps=5, warmup=0)
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
    return launches, sim


def profile_md(sim, steps=10):
    """Where the time of an MD step goes at STMV: device time by kernel
    (torch.profiler's CUDA activity) over one skin chunk."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(steps)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    groups = {"et_fwd_kernel": 0.0, "et_bwd_kernel": 0.0, "ell_transpose_sum_kernel": 0.0,
              "select_topk_kernel": 0.0}
    other = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.device_time / 1e3 / steps
        key = next((k for k in groups if k in ev.name), None)
        if key is None:
            other += ms
        else:
            groups[key] += ms
    busy = sum(groups.values()) + other
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    shares = ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in groups.items())
    log(f"profile of {steps} MD steps at STMV (torch.profiler): wall {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step; {shares}, other kernels {other:.3f} ms ({100 * other / busy:.1f}%)")


def _train_dataset():
    from torchmdnet_tpu_torch.data.datasets import SyntheticMorse

    return SyntheticMorse(num_samples=sum(TRAIN_SPLIT), seed=SEED, **TRAIN_MOL)


def _train_batch(ds, device):
    """The first TRAIN_BATCH molecules as the trainer sees a batch: padded to
    a multiple of 8 atoms, spatially sorted (fused_attention), on ``device``."""
    from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort

    mols = [ds[i] for i in range(TRAIN_BATCH)]
    n = -(-TRAIN_BATCH * TRAIN_MOL["num_atoms"] // 8) * 8
    batch = pad_molecules(mols, num_atoms=n, num_mol=TRAIN_BATCH)
    return spatial_sort(batch, cell=TRAIN_ARGS["cutoff_upper"])[0].to(device)


def _launches():
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    return (em.run_fwd.launches, em.run_bwd.launches, em.run_bwd2.launches, select_topk.launches)


def _reset_launches():
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    em.reset_launch_counts()
    select_topk.launches = 0


def time_train_kernels(batch):
    """#1, #2 (with and without weight cotangents) and #3 at the training
    shapes (N=2304, K=33, H=256, 8 heads, RBF=64), their plain versions and
    bounds (L2 flushed, median of 20)."""
    import torch

    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    h, heads, rbf = TRAIN_ARGS["embedding_dimension"], TRAIN_ARGS["num_heads"], TRAIN_ARGS["num_rbf"]
    nbl, ins, cts = _kernel_inputs(None, TRAIN_ARGS["max_num_neighbors"], h, rbf,
                                   TRAIN_ARGS["cutoff_upper"], SEED, batch=batch)
    n, kk = nbl.idx.shape
    perm = nbl.transpose_perm
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
    common = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]
    kw = dict(heads=heads, act="silu", attn_act="silu")
    z = _z_like(ins, SEED)
    inputs = [ins[x] for x in ORDER]
    ms = dict(
        fwd=_event_ms(lambda: em.run_fwd(nbl.idx, *common, dirs, *w, **kw), flush=flush),
        bwd=_event_ms(lambda: em.run_bwd(nbl.idx, perm, *common, dirs, *w, cts[0], cts[1],
                                         want_weight_grads=False, **kw), flush=flush),
        bwd_w=_event_ms(lambda: em.run_bwd(nbl.idx, perm, *common, dirs, *w, cts[0], cts[1],
                                           want_weight_grads=True, **kw), flush=flush),
        bwd2=_event_ms(lambda: em.run_bwd2(nbl.idx, perm, inputs, cts, z, **kw), flush=flush),
    )
    t = {x: v.clone().requires_grad_(x != "msk") for x, v in ins.items()}
    x_out, vec_out = _call(em.et_messages_reference, nbl, t, heads)
    leaves = [t[x] for x in ORDER if x != "msk"]
    plain = dict(
        fwd=_event_ms(lambda: _call(em.et_messages_reference, nbl, ins, heads), flush=flush),
        bwd_w=_event_ms(lambda: torch.autograd.grad((x_out, vec_out), leaves, cts, retain_graph=True),
                        flush=flush),
        bwd2=_event_ms(lambda: em.et_messages_bwd2_reference(nbl.idx, perm, inputs, cts, z, **kw),
                       flush=flush, reps=5),
    )
    bounds = {k: _bounds(n, kk, h, rbf, k) for k in ms}
    log(f"kernel times at the training shapes (N={n} K={kk} H={h} heads={heads} RBF={rbf}, L2 flushed, "
        f"median of 20; plain second order of 5): "
        + "; ".join(f"{k} {v:.4f} ms (bound {bounds[k][0]:.4f} ms by {bounds[k][1]}"
                    + (f", plain {plain[k]:.4f} ms" if k in plain else "") + ")" for k, v in ms.items()))
    return ms, plain, bounds


def train_grads_vs_composable(ds):
    """One force-loss gradient at the training configuration, fused bf16
    against composable fp32 with the same weights; the fused pass must run
    L forward, 2L backward and L second-order launches."""
    import torch

    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.train.trainer import masked_mse

    batch = _train_batch(ds, "cuda")
    fused = create_model(TRAIN_ARGS, seed=SEED)
    comp = create_model(dict(TRAIN_ARGS, bf16_messages=False, fused_attention=False), seed=SEED)
    comp.module.load_state_dict(fused.module.state_dict())
    grads, launches = {}, None
    for name, model in (("fused", fused), ("composable", comp)):
        _reset_launches()
        nbl = model.neighbors(batch)
        nbl.raise_on_overflow("the training batch")
        y, neg_dy = model.energy_and_forces(batch, nbl=nbl, create_graph=True)
        loss = masked_mse(y, batch.y, batch.mol_mask) + masked_mse(neg_dy, batch.neg_dy, batch.atom_mask)
        names = [k for k, p in model.module.named_parameters() if p.requires_grad]
        g = torch.autograd.grad(loss, [dict(model.module.named_parameters())[k] for k in names])
        torch.cuda.synchronize()
        grads[name] = dict(zip(names, g))
        if name == "fused":
            launches = _launches()[:3]
    layers = TRAIN_ARGS["num_layers"]
    if launches != (layers, 2 * layers, layers):
        raise AssertionError(f"one fused force-loss gradient should launch {layers} fwd, {2 * layers} bwd "
                             f"and {layers} bwd2, got {launches}")
    per = {k: _rel(grads["fused"][k], v) for k, v in grads["composable"].items()}
    num = sum(float((grads["fused"][k].double() - v.double()).pow(2).sum()) for k, v in grads["composable"].items())
    den = sum(float(v.double().pow(2).sum()) for v in grads["composable"].values())
    l2 = math.sqrt(num / den)
    worst = max(per, key=per.get)
    log(f"force-loss gradient at the training configuration (ET 8x256, {TRAIN_BATCH} molecules of "
        f"{TRAIN_MOL['num_atoms']} atoms, N={batch.num_atoms}): launches fwd {launches[0]} bwd {launches[1]} "
        f"bwd2 {launches[2]} (L, 2L, L for L={layers}); fused bf16 vs composable fp32 over "
        f"{len(per)} parameter tensors: max|dg|/max|g| worst {per[worst]:.3e} ({worst}, tol {TRAIN_GRAD_TOL}), "
        f"median {statistics.median(per.values()):.3e}; |dg|/|g| {l2:.3e} (tol {TRAIN_GRAD_L2_TOL})")
    if per[worst] > TRAIN_GRAD_TOL or l2 > TRAIN_GRAD_L2_TOL:
        raise AssertionError("fused force-loss gradients disagree with the composable fp32 path")
    del grads, fused, comp


def _cli_flags(workdir):
    a = TRAIN_ARGS
    train, val, test = TRAIN_SPLIT
    return [
        "--model", a["model"], "--embedding-dimension", str(a["embedding_dimension"]),
        "--num-layers", str(a["num_layers"]), "--num-rbf", str(a["num_rbf"]),
        "--num-heads", str(a["num_heads"]), "--max-num-neighbors", str(a["max_num_neighbors"]),
        "--cutoff-upper", str(a["cutoff_upper"]), "--max-z", str(a["max_z"]),
        "--neighbor-embedding", "true", "--derivative", "true",
        "--bf16-messages", "true", "--fused-attention", "true",
        "--lr", "1e-4", "--batch-size", str(TRAIN_BATCH), "--num-epochs", str(TRAIN_EPOCHS),
        "--train-size", str(train), "--val-size", str(val), "--test-size", str(test),
        "--y-weight", "1.0", "--neg-dy-weight", "1.0", "--seed", str(SEED),
        "--dataset", "SyntheticMorse", "--dataset-root", os.path.join(workdir, "data"),
        "--dataset-arg", json.dumps(dict(num_samples=sum(TRAIN_SPLIT), seed=SEED, **TRAIN_MOL)),
        "--log-dir", os.path.join(workdir, "logs"), "--save-interval", "1", "--num-workers", "0",
    ]


def train_cli(workdir):
    """Force-loss training through the CLI's entry point: losses finite and
    falling, the expected launches, a checkpoint written and reloadable."""
    import torch

    from torchmdnet_tpu_torch.models.potential import load_model
    from torchmdnet_tpu_torch.scripts import train as cli
    from torchmdnet_tpu_torch.train.checkpoints import load_checkpoint

    t0 = time.perf_counter()
    _reset_launches()
    trainer, test_metrics = cli.main(_cli_flags(workdir))
    torch.cuda.synchronize()
    launches = _launches()
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
    layers = TRAIN_ARGS["num_layers"]
    steps = TRAIN_EPOCHS * (TRAIN_SPLIT[0] // TRAIN_BATCH)
    evals = TRAIN_EPOCHS * -(-TRAIN_SPLIT[1] // TRAIN_BATCH) + -(-TRAIN_SPLIT[2] // TRAIN_BATCH)
    expected = (layers * (steps + evals), layers * (2 * steps + evals), layers * steps, 0)
    if launches != expected or trainer.state.global_step != steps:
        raise AssertionError(f"expected launches {expected} for {steps} steps and {evals} evaluation "
                             f"batches, got {launches} after {trainer.state.global_step} steps")
    best = trainer.best_model_path
    ckpt = load_checkpoint(best)
    reloaded = load_model(best)
    same = all(torch.equal(v.cpu(), ckpt["state_dict"][k]) for k, v in reloaded.module.state_dict().items())
    if not same or ckpt["optimizer"] is None:
        raise AssertionError(f"the checkpoint {best} did not reload")
    log(f"training CLI (scripts.train.main, ET 8x256 fused bf16, SyntheticMorse {TRAIN_MOL}, "
        f"{TRAIN_SPLIT} samples, batches of {TRAIN_BATCH}, {TRAIN_EPOCHS} epochs = {steps} steps): "
        f"first step loss {first:.4f}, epoch train losses {[round(v, 4) for v in train_losses]}, "
        f"test {json.dumps({k: round(v, 4) for k, v in test_metrics.items()})}; launches fwd {launches[0]} "
        f"bwd {launches[1]} bwd2 {launches[2]} select_topk {launches[3]} ({steps} steps x (L, 2L, L) + "
        f"{evals} evaluation batches x (L, L, 0), L={layers}); checkpoint {os.path.basename(best)} "
        f"reloads with its optimizer state; {seconds:.1f} s in all (dataset and model setup included)")
    return trainer, launches


def time_train_steps(trainer, ds):
    """Trainer steps on one training batch: host clock with sync around each
    step, median after warm-up; (L, 2L, L) launches per step."""
    import torch

    batch = trainer._prepare_batch(_train_batch(ds, "cpu"))
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
    launches = _launches()[:3]
    layers = TRAIN_ARGS["num_layers"]
    if launches != tuple(c * layers * TRAIN_TIMED_STEPS for c in (1, 2, 1)):
        raise AssertionError(f"expected (L, 2L, L) launches per step, got {launches} in {TRAIN_TIMED_STEPS} steps")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"training step (Trainer, ET 8x256 fused bf16, {TRAIN_BATCH} x {TRAIN_MOL['num_atoms']} atoms, "
        f"host clock with sync, median of {TRAIN_TIMED_STEPS} after {TRAIN_WARMUP_STEPS}): {ms:.3f} ms/step "
        f"(min {min(times):.3f}, max {max(times):.3f}), {1e3 * TRAIN_BATCH / ms:.1f} molecules/s; launches "
        f"per step fwd {launches[0] // TRAIN_TIMED_STEPS} bwd {launches[1] // TRAIN_TIMED_STEPS} bwd2 "
        f"{launches[2] // TRAIN_TIMED_STEPS}; peak memory {peak:.2f} GiB")
    return batch


def profile_train(trainer, batch, steps=3):
    """Where the time of a training step goes: device time by kernel
    (torch.profiler's CUDA activity) against the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acc = torch.zeros(4, dtype=trainer.dtype, device="cuda")
    ema = torch.zeros((), dtype=trainer.dtype, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._train_step(batch, acc, ema, ema)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    groups = {"et_fwd_kernel": 0.0, "et_bwd_kernel": 0.0, "et_bwd2_kernel": 0.0,
              "ell_transpose_sum_kernel": 0.0}
    other, launches = 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.device_time / 1e3 / steps
        key = next((k for k in groups if k in ev.name), None)
        if key is None:
            other += ms
            launches += 1
        else:
            groups[key] += ms
    busy = sum(groups.values()) + other
    if busy <= 0.0:
        raise AssertionError("the profiler recorded no device time")
    shares = ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in groups.items())
    log(f"profile of {steps} training steps (torch.profiler): wall {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step ({100 * busy / wall:.1f}%); {shares}, other kernels {other:.3f} ms "
        f"({100 * other / busy:.1f}%, {launches / steps:.0f} launches/step)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "torchmdnet_tpu_torch")):
        print("chip_smoke: torchmdnet_tpu_torch not found beside chip_smoke.py; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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

    check_kernels("medium", 512, 40, 64, 4, 32, 3.5, seed=1)
    fwd_abs, bwd_abs, _ = check_kernels("DHFR", 2489, 80, 128, 8, 50, 5.0, seed=2)
    train_ds = _train_dataset()
    a = TRAIN_ARGS
    _, _, bwd2_abs = check_kernels("training", None, a["max_num_neighbors"], a["embedding_dimension"],
                                   a["num_heads"], a["num_rbf"], a["cutoff_upper"], seed=4,
                                   batch=_train_batch(train_ds, "cuda"))
    stmv = _stmv_batch()
    keys, k, _ = stmv_skin_keys(stmv)
    sel_abs = check_select_topk(keys, k)
    check_cell_vs_brute(DHFR_ATOMS)
    check_cell_vs_brute(FACTOR_IX_ATOMS)
    ext_launches, ext, pos = main_path()
    times = time_kernels(seed=SEED)
    train_ms, train_plain, train_bounds = time_train_kernels(_train_batch(train_ds, "cuda"))
    sel_time = time_select_topk(keys, k)
    del keys, stmv
    md_launches, sim = md_stmv(sel_time[0])
    train_grads_vs_composable(train_ds)
    with tempfile.TemporaryDirectory() as workdir:
        trainer, train_launches = train_cli(workdir)
    train_batch = time_train_steps(trainer, train_ds)
    # last: the profiler's tracing may slow what runs after it
    profile_calls(ext, pos)
    profile_md(sim)
    profile_train(trainer, train_batch)

    # launches: the counts of the three main paths' runs (External at DHFR
    # size, MD at STMV size, training through the CLI), each counted from 0
    # just before it ran
    ext_launches = ext_launches[:2] + (0,) + ext_launches[2:]
    md_launches = md_launches[:2] + (0,) + md_launches[2:]
    bwd2_row = (train_ms["bwd2"], train_plain["bwd2"]) + train_bounds["bwd2"] + (None,)
    kernels = []
    for name, source, line, (ms, plain_ms, bound_ms, bound_by, lib_ms), err, i in (
        ("et_message_fwd", "et_message.cu", "et_message.py:227", times["fwd"] + (None,), fwd_abs, 0),
        ("et_message_bwd", "et_message.cu", "et_message.py:296", times["bwd"] + (None,), bwd_abs, 1),
        ("et_message_bwd2", "et_message.cu", "et_message.py:685", bwd2_row, bwd2_abs, 2),
        ("select_topk", "select_topk.cu", "select_topk.py:32", sel_time, sel_abs, 3),
    ):
        by_path = {"external_dhfr": ext_launches[i], "md_stmv": md_launches[i], "train": train_launches[i]}
        kernels.append(dict(
            name=name, route="cuda", source=f"torchmdnet_tpu_torch/csrc/{source}",
            replaces=f"torchmdnet_tpu/ops/pallas/{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms,
        ))
        if max(by_path.values()) < 1:
            raise AssertionError(f"{name} was not launched on a main path")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
