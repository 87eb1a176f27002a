"""The configurations, batches and kernel operands that ``chip_smoke.py`` and
the timing tools (``tools/time_bwd.py``, ``tools/time_external.py``) share.

Every model configuration here names its source (``benchmarks/*.py``,
bench.py's lines, ``examples/*.yaml``); the systems are the synthetic ones
of ``data/systems.py`` and the training frames come from ``SyntheticMorse``
or from the npy files that ``write_custom_frames`` writes, so nothing is
downloaded.  The functions build their tensors on the card ("cuda") unless
a device is named, and import the rest of the package when called, so a
caller that swaps in another checkout's package (``time_bwd.py --tree``)
runs that checkout's kernels on these operands.
"""

import math
import os

import numpy as np

from torchmdnet_tpu_torch.profiling import FLUSH_KERNELS, enqueue_ms, event_ms, kernel_profile

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
SEED = 0


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
TRAIN_TIMED_STEPS = 10


# STMV molecular dynamics as bench.py's stmv_md_ms configures it
# (bench.py:397-473): Verlet skin 0.5 A, a rebuild every 10 steps, Langevin
# at 300 K, spatially sorted atoms
MD_ARGS = dict(timestep_fs=1.0, temperature_K=300.0, friction_per_fs=0.01,
               neighbor_skin=0.5, rebuild_every=10)
MD_WARMUP_STEPS = 10
MD_TIMED_STEPS = 10


# a rebuild cadence at which the skin holds: at 300 K the fastest of 30,000
# atoms (hydrogens) start near 0.075 A/fs, so thermal motion alone carries
# them about 0.75 A in bench.py's 10 fs, three times skin/2, whatever the
# potential; in 2 fs about 0.15 A
MD_VALID_EVERY = 2
MD_VALID_STEPS = 10


def _synthetic_batch(n_atoms, seed, device):
    from torchmdnet_tpu_torch.data.batch import pad_molecules
    from torchmdnet_tpu_torch.data.systems import synthetic_system

    z, pos = synthetic_system(n_atoms, seed=seed)
    padded = -(-n_atoms // 32) * 32
    return z, pos, pad_molecules([{"z": z, "pos": pos}], num_atoms=padded, device=device)


def _kernel_inputs(n_atoms, k, h, rbf, cutoff, seed, batch=None, nbl=None):
    """Edge-phase operands on the card: a real ELL list of a synthetic
    system (or of ``batch``, a batch of small molecules: brute search, as
    ``Potential.neighbors`` takes for it; or ``nbl``, a list of ``batch``),
    its geometry and RBFs, random bf16 features and filters."""
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
    if nbl is None:
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


def _stmv_kernel_inputs(seed):
    """#2's operands at ET MD's STMV skin list (30,336 atoms, cutoff 5 A + a
    0.5 A skin, K = 112, the probed cell sizes of ``md.Simulation``), H =
    128, RBF = 50."""
    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    stmv = _stmv_batch()
    skin = MD_ARGS["neighbor_skin"]
    model = create_model(ET_ARGS, seed=SEED)
    nbl = model.neighbors(stmv, skin=skin, **probe_cell_kwargs(stmv, cutoff_upper=ET_ARGS["cutoff_upper"] + skin))
    return _kernel_inputs(None, nbl.idx.shape[1], ET_ARGS["embedding_dimension"], ET_ARGS["num_rbf"],
                          ET_ARGS["cutoff_upper"], seed, batch=stmv, nbl=nbl)


def _z_like(ins, seed):
    """Random cotangents Z on the backward's 16 outputs (none on msk's), in
    their dtypes: the second-order kernel's third operand."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [None if n == "msk" else (torch.randn(ins[n].shape, generator=g) * 0.5).to("cuda", ins[n].dtype)
            for n in ORDER]


def _stmv_batch():
    """Synthetic STMV (seed 0), padded to a multiple of 32, spatially sorted,
    on the card: the batch of bench.py's STMV MD (bench.py:420-425)."""
    from torchmdnet_tpu_torch.data.batch import spatial_sort
    from torchmdnet_tpu_torch.data.systems import STMV_ATOMS

    _, _, batch = _synthetic_batch(STMV_ATOMS, SEED, "cuda")
    return spatial_sort(batch)[0]


def cell_keys(args, batch, skin=0.0):
    """The selection kernel's input at a cell-list build of ``args``' model
    on ``batch``: the candidate key matrix with the cell sizes probed as
    External, md.Simulation and the GN forward probe them, and the k the
    build selects (``Potential.neighbors``' rule, the skin list's k scaled by
    the skin volume).  Returns (keys, k, the probed sizes)."""
    from torchmdnet_tpu_torch.ops.cell_list import cell_candidate_keys, probe_cell_kwargs

    cut = args["cutoff_upper"]
    sizes = probe_cell_kwargs(batch, cutoff_upper=cut + skin)
    keys, _, overflow = cell_candidate_keys(
        batch.pos, batch.batch, batch.atom_mask, cutoff_lower=max(0.0, args["cutoff_lower"] - skin),
        cutoff_upper=cut + skin, **sizes)
    if bool(overflow):
        raise AssertionError(f"a cell-list build at cutoff {cut + skin} overflowed its probed sizes {sizes}")
    k = args["max_num_neighbors"]
    if skin > 0.0:
        k = int(math.ceil(k * ((cut + skin) / cut) ** 3 / 8.0)) * 8
    return keys, min(k, keys.shape[1]), sizes


def stmv_skin_keys(batch):
    """The selection kernel's input at an STMV skin rebuild of ET MD (and GN
    MD, whose cutoff, k and skin are ET's): ``cell_keys`` with the skin."""
    return cell_keys(ET_ARGS, batch, skin=MD_ARGS["neighbor_skin"])


def select_cases(dhfr, stmv, skin_keys, skin_k, zbl_k=None):
    """{label: (keys, k, sentinel)} for each cell-list build a path runs,
    and {path: label}: the DHFR builds of External's four models (cutoff
    and k; the ET, GN and Transformer builds are one, and the ZBL path's
    model builds too), GN's STMV forward (cutoff 5 A, K = 32), the STMV skin
    build of MD, and the ZBL prior's own DHFR build (4 A, K = ``zbl_k``, the
    sizes External probes for it)."""
    from torchmdnet_tpu_torch.ops.cell_list import cell_candidate_keys, probe_cell_kwargs

    models = {"external_dhfr": ET_ARGS, "tn_external_dhfr": TN_ARGS, "gn_external_dhfr": GN_ARGS,
              "t_external_dhfr": T_ARGS, "gn_forward_stmv": GN_STMV_FWD_ARGS, "zbl_external_dhfr": ET_ARGS}
    cases, label_of = {}, {}
    for path, args in models.items():
        batch = dhfr if path.endswith("_dhfr") else stmv
        where = "DHFR" if batch is dhfr else "STMV"
        label = f"{where} build (cutoff {args['cutoff_lower']}-{args['cutoff_upper']} A, K={args['max_num_neighbors']})"
        if label not in cases:
            keys, k, _ = cell_keys(args, batch)
            cases[label] = (keys, k, keys.shape[0])
        label_of[path] = label
    label = "STMV skin build"
    cases[label] = (skin_keys, skin_k, skin_keys.shape[0])
    label_of.update(md_stmv=label, gn_md_stmv=label)
    if zbl_k is None:
        return cases, label_of
    sizes = probe_cell_kwargs(dhfr, cutoff_upper=ZBL_CUTOFF)
    keys, _, overflow = cell_candidate_keys(dhfr.pos, dhfr.batch, dhfr.atom_mask, cutoff_upper=ZBL_CUTOFF, **sizes)
    if bool(overflow):
        raise AssertionError(f"the ZBL prior's DHFR build overflowed its probed sizes {sizes}")
    label = f"DHFR ZBL prior build (cutoff 0-{ZBL_CUTOFF} A, K={zbl_k}, {sizes})"
    cases[label] = (keys, zbl_k, keys.shape[0])
    label_of["zbl_prior_dhfr"] = label
    return cases, label_of


def _train_dataset(split=TRAIN_SPLIT, mol=TRAIN_MOL):
    from torchmdnet_tpu_torch.data.datasets import SyntheticMorse

    return SyntheticMorse(num_samples=sum(split), seed=SEED, **mol)


def _train_batch(ds, device, batch_size=TRAIN_BATCH, cutoff=TRAIN_ARGS["cutoff_upper"], mol=TRAIN_MOL):
    """The first ``batch_size`` molecules as the trainer sees a batch: padded
    to a multiple of 8 atoms, partial charges (``pq``) collated as the loader
    collates them, spatially sorted (the fused paths), on ``device``."""
    from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort

    mols = [ds[i] for i in range(batch_size)]
    keys = ("partial_charges",) if "pq" in mols[0] else ()
    if keys:
        mols = [dict(m, partial_charges=m["pq"]) for m in mols]
    n = -(-batch_size * mol["num_atoms"] // 8) * 8
    batch = pad_molecules(mols, num_atoms=n, num_mol=batch_size, extra_atom_keys=keys)
    return spatial_sort(batch, cell=cutoff)[0].to(device)


# TensorNet configuration of the serving benchmark (benchmarks/inference.py:31-61,
# as bench.py's tensornet_forces_dhfr2489_ms line): 2 x 128, 32 ExpNormal RBFs
# (not trainable), cutoff 0-4.5 A, 64 neighbors, O(3), the fused bf16 message phase
TN_ARGS = dict(
    model="tensornet", embedding_dimension=128, num_layers=2, num_rbf=32, rbf_type="expnorm",
    trainable_rbf=False, activation="silu", cutoff_lower=0.0, cutoff_upper=4.5, max_z=128,
    max_num_neighbors=64, derivative=True, output_model="Scalar", prior_model=None,
    reduce_op="add", precision=32, atom_filter=-1, equivariance_invariance_group="O(3)",
    bf16_messages=True, fused_message=True,
)


# examples/TensorNet-ANI1X.yaml: 2 x 128, 32 RBFs, cutoff 4.5 A, 32 neighbors,
# batches of 64, y_weight 0.5, neg_dy_weight 0.5, lr 2e-4, max_z 128, O(3); with
# the fused bf16 message phase.  SyntheticMorse stands in for ANI1X's files.
TN_TRAIN_ARGS = dict(TN_ARGS, max_num_neighbors=32)
TN_TRAIN_BATCH = 64
TN_TRAIN_SPLIT = (768, 64, 64)  # 12 training batches, one val, one test
TN_TRAIN_LR = 2e-4
TN_TRAIN_WEIGHTS = (0.5, 0.5)  # y_weight, neg_dy_weight
TN_ORDER = ["cat", "ea", "cutm", "w1", "b1", "w2", "b2", "w3", "b3"]


# a periodic cube of random atoms at about water's number density (0.1 / A^3)
TN_BOX_ATOMS = 512


def _tn_kernel_inputs(nbl, pos, h, rbf, cutoff, seed, box=None):
    """Message-phase operands on the card for a list ``nbl`` over ``pos``:
    its RBFs and cutoff from the geometry, random bf16 source rows and MLP."""
    import torch

    from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
    from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components
    from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing

    n = nbl.idx.shape[0]
    _, dist = edge_geometry_components(pos, nbl, box=box)
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda")

    ins = dict(
        cat=rnd(n, 9 * h).to(bf),
        ea=ExpNormalSmearing(0.0, cutoff, rbf).to("cuda")(dist).detach().to(bf),
        cutm=(cosine_cutoff(dist, 0.0, cutoff) * nbl.mask).float().detach(),
        w1=rnd(rbf, h, scale=rbf ** -0.5).to(bf), b1=rnd(1, h, scale=0.1).to(bf),
        w2=rnd(h, 2 * h, scale=h ** -0.5).to(bf), b2=rnd(1, 2 * h, scale=0.1).to(bf),
        w3=rnd(2 * h, 3 * h, scale=(2 * h) ** -0.5).to(bf), b3=rnd(1, 3 * h, scale=0.1).to(bf),
    )
    return ins, rnd(n, 9 * h)


def _tn_system(kind, seed, k=None, cutoff=None):
    """(nbl, pos, box) on the card: "DHFR" (External's list at DHFR size),
    "box" (a periodic cube, brute search) or a training batch (its list at
    ``k`` and ``cutoff``, by default TensorNet-ANI1X's)."""
    import torch

    from torchmdnet_tpu_torch.ops.neighbors import neighbor_list

    box = None
    if kind == "DHFR":
        from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS

        from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

        _, _, batch = _synthetic_batch(DHFR_ATOMS, seed, "cuda")
        k, cut, strategy = TN_ARGS["max_num_neighbors"], TN_ARGS["cutoff_upper"], "auto"
        cell_kwargs = probe_cell_kwargs(batch, cutoff_upper=cut)
    elif kind == "box":
        g = torch.Generator().manual_seed(seed)
        side = (TN_BOX_ATOMS / 0.1) ** (1.0 / 3.0)
        pos = (torch.rand(TN_BOX_ATOMS, 3, generator=g) * side).to("cuda")
        box = torch.eye(3, device="cuda") * side
        nbl = neighbor_list(pos, k=80, cutoff_upper=TN_ARGS["cutoff_upper"], loop=True, box=box,
                            strategy="brute")
        nbl.raise_on_overflow("chip_smoke periodic box")
        return nbl, pos, box
    else:
        batch = kind
        k = TN_TRAIN_ARGS["max_num_neighbors"] if k is None else k
        cut = TN_TRAIN_ARGS["cutoff_upper"] if cutoff is None else cutoff
        strategy = "brute"
        cell_kwargs = {}
    nbl = neighbor_list(batch.pos, batch.batch, batch.atom_mask, k=k, cutoff_upper=cut, loop=True,
                        strategy=strategy, **cell_kwargs)
    nbl.raise_on_overflow("chip_smoke TensorNet kernel inputs")
    return nbl, batch.pos, box


def _tn_z_like(ins, seed):
    """Random cotangents Z on the backward's nine outputs, in their dtypes."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(ins[n].shape, generator=g) * 0.5).to("cuda", ins[n].dtype) for n in TN_ORDER]


def _tn_pass_split(idx, args, ct, flush):
    """#9 at the training shapes pass by pass: the edge kernel alone (no
    per-edge rows), with the rows and their reduction, and the reduction
    (et_dw_kernel) alone on the rows of one launch."""
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    def bwd(want):
        return lambda: tm.run_bwd(idx, *args, ct, act="silu", want_weight_grads=want)

    rows = tm.bwd_rows(idx, *args, ct, act="silu", want_rows=True)[3]
    jobs = tm._bwd_jobs(TN_ARGS["embedding_dimension"], tm._rbfp(TN_ARGS["num_rbf"]))
    return {"edge kernel": event_ms(bwd(False), flush=flush),
            "edge kernel + rows + reduction": event_ms(bwd(True), flush=flush),
            "reduction (et_dw_kernel)": event_ms(lambda: tm.weight_grads(rows, jobs), flush=flush)}


TN_BWD2_KERNELS = ("tn_bwd2_kernel", "tn_src_sum_kernel", "et_dw_kernel")


def _tn_bwd2_split(idx, perm, args, ct, z, flush, reps=20):
    """#10 kernel by kernel: the device time a launch of each of run_bwd2's
    kernels takes (the edge kernel, the source-row sum of g_cat, the weight
    reduction), from torch.profiler over ``reps`` calls with the L2 flushed
    before each: {name: ms}."""
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    def call():
        flush.zero_()
        tm.run_bwd2(idx, perm, args, ct, z, act="silu")

    call()
    return kernel_profile(call, reps, TN_BWD2_KERNELS)[2]


# GN configuration of the serving benchmark (benchmarks/inference.py:31-55, as
# bench.py's gn_forces_dhfr2489_ms line): 6 x 128, 50 trainable ExpNormal
# RBFs, NeighborEmbedding, cutoff 0-5 A, 80 neighbors, add, Scalar head, bf16
# messages (the gathers run #4, their gradients #5)
GN_ARGS = dict(
    model="graph-network", embedding_dimension=128, num_layers=6, num_rbf=50, rbf_type="expnorm",
    trainable_rbf=True, activation="silu", neighbor_embedding=True, cutoff_lower=0.0,
    cutoff_upper=5.0, max_z=128, max_num_neighbors=80, derivative=True, output_model="Scalar",
    prior_model=None, reduce_op="add", precision=32, atom_filter=-1, aggr="add", bf16_messages=True,
)


# bench.py's headline GN forward (bench.py:94-117): the same model in f32,
# max_z 100, no forces, and max_num_neighbors 32, which truncates the list at
# protein density (about 49 neighbors within 5 A) as the reference's
# radius_graph does; the STMV forward (bench.py:300-320) with bf16 messages
GN_FWD_ARGS = dict(GN_ARGS, max_z=100, max_num_neighbors=32, derivative=False, bf16_messages=False)
GN_STMV_FWD_ARGS = dict(GN_FWD_ARGS, bf16_messages=True)


# GN MD at STMV size (bench.py's gn_stmv_force_md_ms_per_step: K = 80, skin
# 0.5 A, so a skin list of K = 112) at a rebuild cadence at which the skin
# holds, without remat (the residuals of six layers fit on the card).  GN's
# random weights give forces several times ET's, which carried atoms 1.089 A
# in 2 fs on the card; the model's output is standardized by std = 0.1
# (EnergyModel's std), at which a rebuild every 2 fs holds.  The time per
# step does not depend on it.
GN_MD_STD = 0.1
GN_MD_EVERY = MD_VALID_EVERY
GN_MD_WARMUP_STEPS = 2
GN_MD_TIMED_STEPS = 10


# GN force training: BASELINE.json configs[1] (GN on MD17 aspirin) with
# examples/ET-MD17.yaml's settings and --model graph-network: 6 x 128, 32
# ExpNormal RBFs (not trainable), cutoff 0-5 A, 32 neighbors,
# NeighborEmbedding, batches of 8, y_weight 0.2, neg_dy_weight 0.8, lr 5e-4;
# bf16 messages.  SyntheticMorse molecules of aspirin's 21 atoms (MD17 needs a
# download) in a 6.3 A cell, the 2 A spacing of the other training paths.
GN_TRAIN_ARGS = dict(GN_ARGS, num_rbf=32, trainable_rbf=False, max_z=100, max_num_neighbors=32)
GN_TRAIN_BATCH = 8
GN_TRAIN_MOL = dict(num_atoms=21, cell=6.3)
GN_TRAIN_SPLIT = (96, 16, 16)  # 12 training batches, two val, two test
GN_TRAIN_LR = 5e-4
GN_TRAIN_WEIGHTS = (0.2, 0.8)


# widths for the kernel checks: a ragged last span of #5 (130 = 2 x 64 + 2
# channels; #4 copies one bf16 at a time there) and one bf16 for both (odd)
GN_PAIR_F = 130
GN_ODD_F = 13


def _gn_lists():
    """GN's lists on the card, one for each shape a GN path runs #4/#5 at:
    External's at DHFR (cell list, probed sizes, K = 80), the STMV skin list
    of MD (cutoff 5.5 A, K = 112), the STMV forward's (bench.py's K = 32,
    truncated) and a GN-aspirin training batch's (8 molecules of 21 atoms,
    brute, K = 32)."""
    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    model = create_model(GN_ARGS, seed=SEED)
    _, _, dhfr = _synthetic_batch(DHFR_ATOMS, SEED, "cuda")
    stmv = _stmv_batch()
    skin, cut = MD_ARGS["neighbor_skin"], GN_ARGS["cutoff_upper"]
    train = _train_batch(_train_dataset(GN_TRAIN_SPLIT, GN_TRAIN_MOL), "cuda", GN_TRAIN_BATCH,
                         GN_TRAIN_ARGS["cutoff_upper"], GN_TRAIN_MOL)
    lists = {
        "DHFR": model.neighbors(dhfr, **probe_cell_kwargs(dhfr, cutoff_upper=cut)),
        "STMV skin": model.neighbors(stmv, skin=skin, **probe_cell_kwargs(stmv, cutoff_upper=cut + skin)),
        "STMV forward": create_model(GN_STMV_FWD_ARGS, seed=SEED).neighbors(
            stmv, **probe_cell_kwargs(stmv, cutoff_upper=GN_STMV_FWD_ARGS["cutoff_upper"])),
        "training": create_model(GN_TRAIN_ARGS, seed=SEED).neighbors(train),
    }
    if bool(lists["STMV forward"].cell_overflow):  # truncated at K = 32 by design, as bench.py's
        raise AssertionError("the GN STMV forward's cell list overflowed its probed sizes")
    for name in ("DHFR", "STMV skin", "training"):
        lists[name].raise_on_overflow(f"chip_smoke GN {name} list")
    return lists


def _three_ways(fn, flush, kernel, reps=20):
    """One call timed three ways: the CUDA-event window (L2 flushed, median
    of 20); the device time alone of the kernels whose names contain
    ``kernel`` (``device_ms``, ``launches``) and of the call's other kernels
    (``other_ms``, ``other_launches``), from ``kernel_profile``, mean of ``reps``
    calls with the L2 flushed before each, the flush's kernels left out by
    name; and the host's enqueue (no synchronise, median of 200)."""
    fn()
    _, _, groups, other, others, counts = kernel_profile(lambda: (flush.zero_(), fn()), reps, FLUSH_KERNELS + (kernel,))
    if not (groups[kernel] > 0.0 and any(counts[f] for f in FLUSH_KERNELS)):
        raise AssertionError(f"the profiler did not tell the flush from the call: {groups}, other {other} ms")
    return dict(ms=event_ms(fn, flush=flush), device_ms=groups[kernel], launches=counts[kernel], other_ms=other,
                other_launches=others, enqueue_ms=enqueue_ms(fn))


def ell_cases(lists):
    """#4 and #5 on each of ``_gn_lists`` at GN's width, operands drawn
    from SEED: yields (shape name, (N, K, F),
    {kind: (kernel call, plain call, library call)}).  The STMV forward's
    truncated list has no transpose (its forward needs none), so #4 only.
    The library calls: ``index_select`` for #4, ``index_add_`` into f32 of
    the rows in f32 for #5 (its atomics add in no fixed order)."""
    import torch

    from torchmdnet_tpu_torch.ops import neighbors as nb
    from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg

    f = GN_ARGS["embedding_dimension"]
    g = torch.Generator().manual_seed(SEED)
    for where, nbl in lists.items():
        n, k = nbl.idx.shape
        idx, flat = nbl.idx, nbl.idx.reshape(-1).long()
        x = torch.randn(n, f, generator=g).to("cuda", torch.bfloat16)
        calls = dict(gather=(lambda: eg.gather_rows(x, idx), lambda: nb._gather_rows(x, idx),
                             lambda: x.index_select(0, flat)))
        if where != "STMV forward":
            perm = nbl.transpose_perm
            ct = torch.randn(n, k, f, generator=g).to("cuda", torch.bfloat16)
            rows32 = ct.reshape(n * k, f).float()
            acc = torch.zeros(n, f, device="cuda")
            calls["transpose"] = (lambda: eg.transpose_sum_rows(ct, idx, perm),
                                  lambda: nb._transpose_sum(ct, idx, perm),
                                  lambda: acc.index_add_(0, flat, rows32))
        yield where, (n, k, f), calls
        del calls
        torch.cuda.empty_cache()


# Transformer configuration of the serving benchmark (benchmarks/inference.py:31-55,
# model_args("transformer")): 6 x 128, 8 heads, 50 trainable ExpNormal RBFs,
# NeighborEmbedding, distance_influence "both", cutoff 0-5 A, 80 neighbors
# (+ the self loop), Scalar head, the fused bf16 edge phase
T_ARGS = dict(ET_ARGS, model="transformer")


# benchmarks/training.py with --model transformer --forces --fused-attention:
# ET's training shapes (8 x 256, 64 RBFs, K = 32, batches of 128 molecules of
# 18 atoms), NeighborEmbedding, 8 heads
T_TRAIN_ARGS = dict(TRAIN_ARGS, model="transformer")
T_ORDER = ["q", "k", "v", "ea", "cutm", "wdk", "bdk", "wdv", "bdv"]


def _t_kernel_inputs(n_atoms, k, h, rbf, cutoff, seed, batch=None, influence="both", nbl=None):
    """The Transformer edge phase's operands on the card: ET's (a real ELL
    list and its geometry, random bf16 rows and filters) cut to T's widths;
    filters absent where ``influence`` leaves them out."""
    nbl, ins, cts = _kernel_inputs(n_atoms, k, h, rbf, cutoff, seed, batch=batch, nbl=nbl)
    t = dict(q=ins["q"], k=ins["k"], v=ins["v"][:, :h].contiguous(), ea=ins["ea"], cutm=ins["cutm"],
             wdk=ins["wdk"], bdk=ins["bdk"], wdv=ins["wdv"][:, :h].contiguous(),
             bdv=ins["bdv"][:, :h].contiguous())
    if influence not in ("keys", "both"):
        t["wdk"] = t["bdk"] = None
    if influence not in ("values", "both"):
        t["wdv"] = t["bdv"] = None
    return nbl, t, cts[0]


def _t_z_like(ins, seed):
    """Random cotangents Z on the backward's nine outputs, in their dtypes
    (None for an absent filter)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [None if ins[n] is None else (torch.randn(ins[n].shape, generator=g) * 0.5).to("cuda", ins[n].dtype)
            for n in T_ORDER]


def compaction_shapes():
    """#7's two shapes on the synthetic DHFR system (N 2496): the row shape
    of External's list and of the check (K 80, cutoff 0-5 A, no loop), and
    the Transformer MD build's (``Potential.neighbors`` with bench.py's
    skin: cutoff and K grown by the skin, the self loop)."""
    a, skin = T_ARGS, MD_ARGS["neighbor_skin"]
    hi = a["cutoff_upper"] + skin
    k = int(math.ceil(a["max_num_neighbors"] * (hi / a["cutoff_upper"]) ** 3 / 8.0)) * 8
    return {
        "DHFR": dict(k=a["max_num_neighbors"], cutoff_lower=a["cutoff_lower"], cutoff_upper=a["cutoff_upper"],
                     loop=False),
        "MD build": dict(k=k, cutoff_lower=max(0.0, a["cutoff_lower"] - skin), cutoff_upper=hi, loop=True),
    }


ZBL_CUTOFF = 4.0


# --- the published configurations (examples/*.yaml) and bench.py's GN MD line ---

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "examples")
# the fused flags of each family (the yaml files name none): bf16 messages
# through the hand-written kernels
FUSED_FLAGS = {"equivariant-transformer": ["--bf16-messages", "true", "--fused-attention", "true"],
               "tensornet": ["--bf16-messages", "true", "--fused-message", "true"]}
# examples/ET-SPICE.yaml (8 x 256, 8 heads, 64 RBFs, 0-10 A, K 128, forces,
# batches of 32) and examples/TensorNet-SPICE.yaml (2 x 128, 32 RBFs, 0-10 A,
# K 128, forces, batches of 16) on Custom npy files of molecules of these
# sizes (SPICE's run from tens of atoms to about a hundred), so that ET's
# batches pad to 32 x 96 = 3072 atoms.  The real SPICE file is not in the
# repository.
SPICE_CONFS = {"ET": "ET-SPICE.yaml", "TensorNet": "TensorNet-SPICE.yaml"}
SPICE_SIZES = (24, 48, 72, 96)
SPICE_FRAMES = 48  # a file: 192 frames in all
# (train, val, test) frames of each configuration: four training steps an
# epoch, one validation and one test batch
SPICE_SPLITS = {"ET": (128, 32, 32), "TensorNet": (64, 16, 16)}
# examples/ET-QM9.yaml (8 x 256, K 64, batches of 128, Atomref, energies only)
# and examples/TensorNet-QM9.yaml (2 x 128, 4.5 A, K 64, batches of 128,
# Atomref, energies only) on energy-only Custom files of QM9-sized molecules
# (QM9's have at most 29 atoms with their hydrogens): N = 128 x 29 = 3712
QM9_CONFS = {"ET": "ET-QM9.yaml", "TensorNet": "TensorNet-QM9.yaml"}
QM9_SIZES = (9, 17, 23, 29)
QM9_FRAMES = 128  # a file: 512 frames in all
QM9_SPLIT = (256, 128, 128)  # two training steps an epoch, one val and one test batch
# the one cut of the run: three epochs (the files' learning-rate warmup, 500
# to 10,000 steps, stays, so the run trains at a small fraction of the rate)
EXAMPLE_EPOCHS = 3
# which path covers the two configurations no phase runs: ET-ANI1.yaml has
# ET-QM9.yaml's widths (8 x 256, K 64, Atomref, energies) at batches of 64,
# TensorNet-rMD17.yaml TensorNet-ANI1X.yaml's (2 x 128, 4.5 A, K 32, forces)
# at batches of 8
COVERED_BY = {"ET-ANI1.yaml": "ET-QM9.yaml", "TensorNet-rMD17.yaml": "TensorNet-ANI1X.yaml"}
# bench.py's gn_stmv_force_md_ms_per_step (bench.py:265-266, 396-473): GN_ARGS
# (6 x 128, 50 RBFs, 5 A, K 80, bf16 messages) with remat, MD at STMV size
# with a 0.5 A skin, at bench.py's rebuild every 10 steps and at GN_MD_EVERY
GN_REMAT_ARGS = dict(GN_ARGS, remat=True)
GN_REMAT_STEPS = 10  # timed at bench.py's cadence, after a window of 10
# optimize() serving ET at DHFR size: ET_ARGS, skin 0.5 A, a rebuild every 10
# calls, 30 calls, each moving every atom by a seeded normal step of this
# many A a coordinate (about 0.1 A in 10 calls, under skin/2)
OPT_SKIN = 0.5
OPT_REBUILD_EVERY = 10
OPT_CALLS = 30
OPT_STEP = 0.005
# SyntheticMorse's molecules: a jittered grid of ceil(n^(1/3)) atoms a side,
# 2 A apart (TRAIN_MOL's 18 atoms in a 6 A cell)
MORSE_SPACING = 2.0


def morse_frames(n_atoms, frames, seed, atom_types=(1, 6, 7, 8)):
    """``frames`` conformations of one molecule of ``n_atoms`` atoms with
    SyntheticMorse's Morse labels: (z (n,), pos (F, n, 3) f32, energies (F,)
    f64, forces (F, n, 3) f64), the energies and forces those of
    ``SyntheticMorse._energy_forces`` (eV, eV/A) computed for all frames at
    once.  Positions: SyntheticMorse's jittered grid; the element-pair
    parameters: a SyntheticMorse's of the same seed."""
    from torchmdnet_tpu_torch.data.datasets import SyntheticMorse

    rng = np.random.default_rng(seed)
    morse = SyntheticMorse(num_samples=1, num_atoms=2, atom_types=atom_types, seed=seed)
    z = rng.choice(np.asarray(atom_types), size=n_atoms).astype(np.int64)
    side = int(np.ceil(n_atoms ** (1 / 3) - 1e-9))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n_atoms]
    pos = (grid * MORSE_SPACING + rng.uniform(-0.3, 0.3, size=(frames, n_atoms, 3))).astype(np.float32)
    p = pos.astype(np.float64)
    d = p[:, :, None, :] - p[:, None, :, :]  # d[f, i, j] = pos_i - pos_j
    r = np.linalg.norm(d, axis=-1)
    off = ~np.eye(n_atoms, dtype=bool)
    eps, r0 = morse._eps[z[:, None], z[None, :]], morse._r0[z[:, None], z[None, :]]
    ex = np.exp(-morse.alpha * (np.where(off, r, 1.0) - r0))
    energy = 0.5 * np.where(off, eps * (ex * ex - 2 * ex), 0.0).sum(axis=(1, 2))
    dedr = np.where(off, eps * 2 * morse.alpha * (ex - ex * ex), 0.0)
    forces = -(dedr[..., None] * d / np.where(off, r, 1.0)[..., None]).sum(axis=2)
    return z, pos, energy, forces


def write_custom_frames(root, sizes, frames, seed=SEED, forces=True):
    """Custom's npy files under ``root``: for each molecule size n, one file
    of ``frames`` Morse-labelled conformations (``morse_frames``):
    coord_<n>.npy (F, n, 3), embed_<n>.npy (n,), energy_<n>.npy (F, 1) and,
    with ``forces``, force_<n>.npy (F, n, 3).  Returns the training CLI's
    flags that name them (``--dataset Custom --coord-files ...``)."""
    os.makedirs(root, exist_ok=True)
    for i, n in enumerate(sizes):
        z, pos, energy, force = morse_frames(n, frames, seed + i)
        arrays = dict(coord=pos, embed=z, energy=energy[:, None].astype(np.float32))
        if forces:
            arrays["force"] = force.astype(np.float32)
        for name, value in arrays.items():
            np.save(os.path.join(root, f"{name}_{n:03d}.npy"), value)
    flags = ["--dataset", "Custom"]
    for name in ("coord", "embed", "energy") + (("force",) if forces else ()):
        flags += [f"--{name}-files", os.path.join(root, f"{name}_*.npy")]
    return flags


def example_flags(conf, data_flags, split, log_dir, model):
    """The training CLI's flags for ``examples/<conf>`` unchanged but for the
    dataset (``data_flags``), the splits, EXAMPLE_EPOCHS, the log directory
    and the fused flags of ``model``'s family."""
    train, val, test = split
    return ["--conf", os.path.join(EXAMPLES, conf), *data_flags, "--train-size", str(train), "--val-size", str(val),
            "--test-size", str(test), "--num-epochs", str(EXAMPLE_EPOCHS), "--log-dir", log_dir, *FUSED_FLAGS[model]]
