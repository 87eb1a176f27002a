"""Operations and bytes of the ET model and of its fused edge-phase kernels,
from the inputs' shapes and the pairs the inputs hold.

Counts are what the inputs need, whatever kernel implements them: ``n``
real atoms, ``pairs`` ordered pairs within the cutoff plus each atom's
self pair (what ET's neighbor list holds), ``pairs_ne`` the same without
the self pairs (what NeighborEmbedding sums over).  Padding atoms and
empty neighbor slots count for nothing.  Each input byte is read once and
each output byte written once.

A pass's floor time is the larger of its bytes over the memory bandwidth
and its operations over the rates that fit them: the filter products on
the bf16 tensor cores, the per-edge elementwise chain in f32 on the CUDA
cores.
"""

BF16, F32, I32 = 2, 4, 4


def _shape(a):
    return a["embedding_dimension"], a["num_rbf"], a["num_layers"]


def forward_flops(a, n, pairs, pairs_ne):
    """Matrix-product operations of one ET forward (energies only): the
    neighbor embedding, per layer the node projections (q, k: H x H; v, the
    three vector components and o: H x 3H) and the distance filters
    (RBF x H and RBF x 3H on every pair), and the EquivariantScalar head."""
    h, r, layers = _shape(a)
    embed = 2 * pairs_ne * r * h + 2 * n * 2 * h * h
    layer = 2 * n * h * h * (1 + 1 + 3 + 9 + 3) + 2 * pairs * r * 4 * h
    hh = h // 2
    head = 2 * n * (3 * h * h + 3 * h * hh + 2 * h * h + h * 2 * hh) + 2 * n * (3 * hh * hh + 3 * hh + 2 * hh * hh + hh * 2)
    return embed + layers * layer + head


# the model's matrix products a step needs, in forwards: MD takes the
# forward and the positions' cotangent (one product per forward product)
STEP_FORWARDS = {"md": 2}


def step_flops(kind, a, n, pairs, pairs_ne):
    return STEP_FORWARDS[kind] * forward_flops(a, n, pairs, pairs_ne)


def _node_bytes(a, n):
    h = a["embedding_dimension"]
    return n * h * BF16 * (1 + 1 + 3 + 3), n * h * F32 * 4  # q, k, v, vec in bf16; x_agg, vec_agg in f32


def _pair_bytes(a, pairs):
    r = a["num_rbf"]
    return pairs * (r * BF16 + 5 * F32 + I32)  # ea, cutm, msk, three directions, the neighbor id


def _filter_bytes(a):
    h, r, _ = _shape(a)
    return (r + 1) * 4 * h * BF16


def passes(a, n, pairs):
    """{pass: (tensor-core operations, f32 elementwise operations, bytes)}
    of one layer's edge phase: ``fwd`` (#1) and ``bwd`` (#2 with its source
    pass, the positions' cotangent only)."""
    h, r, _ = _shape(a)
    filt = 2 * pairs * r * 4 * h  # one product of every pair's RBF row with the (RBF, 4H) filters
    node_in, node_out = _node_bytes(a, n)
    pair_in = _pair_bytes(a, pairs)
    wts = _filter_bytes(a)
    fwd = (filt, 36 * pairs * h, node_in + pair_in + wts + node_out)
    # in: the forward's inputs and the outputs' cotangents; out: the
    # cotangents of q, k, v, vec (f32), of ea (bf16) and of cutm and the
    # directions (f32)
    bwd_bytes = node_in + pair_in + wts + node_out + n * h * F32 * 8 + pairs * (r * BF16 + 4 * F32)
    bwd = (2 * filt, 72 * pairs * h, bwd_bytes)
    return {"fwd": fwd, "bwd": bwd}


def floor_s(work, peaks):
    """A pass's least time on the chip: (seconds, "bytes" or "operations")."""
    tc, simt, nbytes = work
    t_ops = tc / peaks["bf16_tensor_flops"] + simt / peaks["f32_flops"]
    t_mem = nbytes / peaks["hbm_bytes_per_s"]
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")
