"""The tiles, items and per-edge units of the port's fused TensorNet forward
(#8), on the CPU.

The CUDA forward (``tn_fwd_kernel``, ``csrc/tn_message.cu``) gives each
block (one an SM, 576 threads) a contiguous range of receiver rows and walks
their flattened edges (i*K + k) in tiles of 64 across rows.  Each layer of
the edge MLP is split into items of 32 rows by N/(H/16) columns, one a warp
for the first H/8 warps; W2 and W3 pass through a two-slice ring of 32 k
rows in the tile that later holds w.  The per-edge phase's units are
(component c, channel pair q), 9H/2 of them, one a thread (thread t takes
unit t); each sums bf16(cat[j, c, pair] * w[third(c), pair]) over its row's
slots in order, with the next four edges' cat pairs in flight in a register
ring whose refill re-reads the tile's last edge past its end.  The mirrors below (``plan``, ``walk``, ``units``, ``items``,
``layout``) follow the kernel's host plan and device loops.
Here:

- at ragged N and K the walk visits every edge exactly once, each edge's
  tracked row and slot equal its flattened index, in ascending slot order
  per row;
- the units cover each of the 9H output channels of a row exactly once,
  one a thread, and each unit's w column is its component's third;
- every layer's items cover its (64, N) output exactly once, at every width
  the kernel takes (H = 32 to 128) and RBF up to 128;
- the shared-memory layout fits a block's 227 KB at every shape the kernel
  takes, and the tile holding w holds both rings;
- the register ring hands each edge its own gathered values;
- in f64, summing each slot's unit products in the walk's order gives
  ``tn_messages_reference``.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, neighbor_list
from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing

# the kernel's constants (csrc/tn_message.cu) and an H100's limits
TILE = 64
THREADS = 576  # FWD_THREADS: 9 * 128 / 2
WARPS = THREADS // 32
KS = 32
AHEAD = 4
SMS = 132
SMEM_MAX = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin

ORDER = ["cat", "ea", "cutm", "w1", "b1", "w2", "b2", "w3", "b3"]
THIRD = [0, 1, 1, 1, 2, 2, 2, 2, 2]  # I, A x3, S x5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plan(n, sms=SMS):
    """(rows a block, blocks), as plan_tiles."""
    rows = -(-n // sms)
    return rows, -(-n // rows)


def walk(n, k, rows, blocks):
    """The edges in the order the per-edge phase visits them: yields
    (block, tile, edge, row, slot) with the row and slot it tracks."""
    for b in range(blocks):
        r0, r1 = b * rows, min(n, (b + 1) * rows)
        if r0 >= r1:
            continue
        e0, e1 = r0 * k, r1 * k
        cur, slot = r0, 0
        for t, t0 in enumerate(range(e0, e1, TILE)):
            for e in range(min(TILE, e1 - t0)):
                if slot == k:
                    cur += 1
                    slot = 0
                slot += 1
                yield b, t, t0 + e, cur, slot - 1


def units(h):
    """Per thread, its unit as (cat column, w column) of the first of the
    pair, or None past 9H/2: thread t is component t // (H/2), pair t % (H/2)."""
    out = []
    for tid in range(THREADS):
        c, q = divmod(tid, h // 2)
        out.append((c * h + 2 * q, THIRD[c] * h + 2 * q) if tid < 9 * h // 2 else None)
    return out


def items(h, rbfp):
    """Per layer (name, N): the (row0, col0, column width) of each warp's item."""
    out = {}
    for name, ncols, cw in (("L1", h, 1), ("L2", 2 * h, 2), ("L3", 3 * h, 3)):
        assert ncols == cw * 16 * (h // 16)
        out[(name, ncols)] = [((w & 1) * 32, (w >> 1) * 16 * cw, cw) for w in range(WARPS) if w < h // 8]
    return out


def _a128(x):
    return (x + 127) // 128 * 128


def _ring(ncols):
    """A forward ring: two slices of KS rows of (ncols + 8)."""
    return 2 * KS * (ncols + 8) * 2


def layout(h, rbfp):
    """edge_layout(h, rbfp, fwd=True): {region: (offset, bytes)} and the total."""
    m, sld = TILE, lambda w: w + 8
    regions = [("w1", rbfp * sld(h) * 2), ("bias", 6 * h * 4), ("ea", 2 * m * sld(rbfp) * 2), ("idx", 2 * m * 4),
               ("cm", 2 * m * 4), ("p1", 0), ("t1", m * sld(h) * 2), ("t2", m * sld(2 * h) * 2), ("p2", 0),
               ("p3", m * sld(3 * h) * 2), ("red", 0)]
    out, o = {}, 0
    for name, nbytes in regions:
        out[name] = (o, nbytes)
        o = _a128(o + nbytes)
    return out, o


@pytest.mark.parametrize("n,k", [(2496, 65), (1152, 33), (1153, 33), (130, 40), (7, 81)])
def test_walk_covers_every_edge_once_in_slot_order(n, k):
    rows, blocks = plan(n)
    assert blocks <= SMS
    seen = np.zeros((n, k), dtype=np.int64)
    last = np.full(n, -1)
    for _, _, e, row, slot in walk(n, k, rows, blocks):
        assert (row, slot) == divmod(e, k)
        assert slot > last[row]
        last[row] = slot
        seen[row, slot] += 1
    assert (seen == 1).all()


def test_tiles_cross_rows_at_the_dhfr_and_training_shapes():
    """64-edge tiles cut across rows: at DHFR (K = 65, 19 rows on each of 132
    blocks) every row spans two tiles and a tile holds parts of one or two
    rows; at training (K = 33, 9 rows on each of 128 blocks) a row spans one
    or two tiles and a tile holds parts of two or three."""
    for n, k, grid, spans, per_tile in ((2496, 65, (19, 132), {2}, {1, 2}), (1152, 33, (9, 128), {1, 2}, {2, 3})):
        rows, blocks = plan(n)
        assert (rows, blocks) == grid
        tiles_of_row, rows_of_tile = {}, {}
        for b, t, _, row, _ in walk(n, k, rows, blocks):
            tiles_of_row.setdefault(row, set()).add((b, t))
            rows_of_tile.setdefault((b, t), set()).add(row)
        assert {len(v) for v in tiles_of_row.values()} == spans
        assert {len(v) for v in rows_of_tile.values()} == per_tile


@pytest.mark.parametrize("h", [32, 64, 96, 128])
def test_units_cover_each_channel_once(h):
    cover = np.zeros(9 * h, dtype=np.int64)
    for mine in units(h):
        if mine is None:
            continue
        ccol, wcol = mine
        c = ccol // h
        assert ccol % 2 == 0 and wcol == THIRD[c] * h + ccol % h
        cover[ccol:ccol + 2] += 1
    assert (cover == 1).all()
    # the idle threads are whole warps at every width but H = 96 (432 units)
    assert sum(u is not None for u in units(h)) == 9 * h // 2
    if h == 128:
        assert all(u is not None for u in units(h))


@pytest.mark.parametrize("h", [32, 64, 96, 128])
def test_items_cover_every_product_once(h):
    for rbf in (8, 32, 50, 80, 128):
        rbfp = -(-rbf // 16) * 16
        for (name, ncols), its in items(h, rbfp).items():
            cover = np.zeros((TILE, ncols), dtype=np.int64)
            for row0, col0, cw in its:
                cover[row0:row0 + 32, col0:col0 + 16 * cw] += 1
            assert (cover == 1).all(), (h, rbfp, name)


@pytest.mark.parametrize("h", [32, 64, 96, 128])
def test_shared_memory_fits_and_holds_the_rings(h):
    for rbf in range(16, 129, 16):
        regions, total = layout(h, rbf)
        assert total <= SMEM_MAX, (h, rbf, total)
        # p3: L2's ring, then L3's ring, then w
        assert regions["p3"][1] >= max(_ring(2 * h), _ring(3 * h))
        # the value tiles are 128-byte multiples, so t2 follows t1 at once
        assert regions["t2"][0] == regions["t1"][0] + regions["t1"][1]
        # 16-byte rows in the tiles and rings (cp.async, ldmatrix)
        for ncols in (rbf, h, 2 * h, 3 * h):
            assert (ncols + 8) * 2 % 16 == 0


@pytest.mark.parametrize("mv", [1, 3, 4, 5, 37, 64])
def test_register_ring_hands_each_edge_its_values(mv):
    """The per-edge loop's ring: slot u holds edge eb + u's gather, refilled
    after use with edge e + AHEAD's, clamped to the tile's last edge."""
    fetch = lambda e: min(e, mv - 1)
    ring = [fetch(u) for u in range(AHEAD)]
    used = []
    for eb in range(0, mv, AHEAD):
        for u in range(AHEAD):
            e = eb + u
            if e >= mv:
                break
            used.append(ring[u])
            ring[u] = fetch(e + AHEAD)
    assert used == list(range(mv))


def _inputs(seed, h, n=40, k=33, rbf=8, cutoff=2.6):
    """f64 operands on a symmetric list of n atoms with k slots (ea and cutm
    from the distances), from numpy."""
    rng = np.random.RandomState(seed)
    pos = torch.as_tensor(rng.uniform(0, 5.0, (n, 3)))
    nbl = neighbor_list(pos, k=k - 1, cutoff_upper=cutoff, loop=True, strategy="brute")  # + the self slot
    nbl.raise_on_overflow("test")
    assert tuple(nbl.idx.shape) == (n, k)
    _, dist = edge_geometry_components(pos, nbl)
    r = lambda *s: torch.as_tensor(rng.randn(*s))
    ins = dict(
        cat=r(n, 9 * h), ea=ExpNormalSmearing(0.0, cutoff, rbf, buffer_dtype=torch.float64)(dist).detach(),
        cutm=cosine_cutoff(dist, 0.0, cutoff) * nbl.mask,
        w1=r(rbf, h) * 0.4, b1=r(1, h) * 0.1, w2=r(h, 2 * h) * h ** -0.5, b2=r(1, 2 * h) * 0.1,
        w3=r(2 * h, 3 * h) * (2 * h) ** -0.5, b3=r(1, 3 * h) * 0.1,
    )
    return nbl, [ins[name] for name in ORDER]


def test_walk_order_sum_of_unit_products_is_the_plain_forward_f64():
    h = 32
    nbl, inputs = _inputs(5, h)
    n, k = nbl.idx.shape
    want = tm.tn_messages_reference(nbl.idx, *inputs, perm=nbl.transpose_perm)
    cat = inputs[0]
    w = tm._edge_weights(*inputs[1:], "silu").reshape(n, k, 3 * h)  # w = MLP(ea) * cutm
    rows, blocks = plan(n, sms=3)  # a small grid: ragged row ranges and tiles
    assert blocks > 1 and (rows * k) % TILE
    got = torch.zeros_like(want)
    mine = [u for u in units(h) if u is not None]
    ccols = torch.tensor([c + i for c, _ in mine for i in (0, 1)])
    wcols = torch.tensor([c + i for _, c in mine for i in (0, 1)])
    for _, _, _, row, slot in walk(n, k, rows, blocks):
        # every unit's pair of products, into its row's sums
        got[row, ccols] += cat[int(nbl.idx[row, slot]), ccols] * w[row, slot, wcols]
    assert want.dtype == torch.float64 and want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
