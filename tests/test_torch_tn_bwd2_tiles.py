"""The tiles and items of the port's fused TensorNet second order (#10), on
the CPU.

The CUDA second order (``tn_bwd2_kernel``, ``csrc/tn_message.cu``) gives
each block (one an SM) a contiguous range of receiver rows and walks their
flattened edges (i*K + k) in tiles of 32; its per-edge phase tracks each
edge's receiver row and slot itself and keeps each row's g_ct sums
sequential in one thread.  Every layer's dual product is split into items
of 16 rows by N/(H/16) columns, one a warp for the first H/8 of its 16
warps (g_ea's into RBFP/8 items of 16 by 16), and the layers' value and
tangent tiles share shared memory where their lives do not overlap.  The
mirrors below (``plan``, ``walk``, ``items``, ``layout``) follow the
kernel's host plan and device loops.  Here:

- at ragged N and K the walk visits every edge exactly once, each edge's
  tracked row and slot equal its flattened index, in ascending slot order
  per row;
- every layer's items cover its (32, N) output exactly once, at every
  width the kernels take (H = 32 to 128) and RBF up to 128;
- the shared-memory layout fits a block's 227 KB where the kernel takes the
  shape (RBF <= 80 at H = 128, every RBF <= 128 below) and not past it, and
  each shared region is big enough for everything that lives in it;
- in f64, summing each slot's g_ct term (``tn_messages_bwd2_reference``
  with cutm and its Z zero on every other slot) in the walk's order gives
  the plain g_ct.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, neighbor_list
from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing

# the kernel's constants (csrc/tn_message.cu) and an H100's limits
TILE = 32
WARPS = 16
KS2 = 16
SMS = 132
SMEM_MAX = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin

ORDER = ["cat", "ea", "cutm", "w1", "b1", "w2", "b2", "w3", "b3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plan(n, sms=SMS):
    """(rows a block, blocks), as plan_bwd."""
    rows = -(-n // sms)
    return rows, -(-n // rows)


def walk(n, k, rows, blocks):
    """The edges in the order the per-edge phase visits them: yields
    (block, edge, row, slot) with the row and slot it tracks."""
    for b in range(blocks):
        r0, r1 = b * rows, min(n, (b + 1) * rows)
        if r0 >= r1:
            continue
        e0, e1 = r0 * k, r1 * k
        cur, slot = r0, 0
        for t0 in range(e0, e1, TILE):
            for e in range(min(TILE, e1 - t0)):
                if slot == k:
                    cur += 1
                    slot = 0
                slot += 1
                yield b, t0 + e, cur, slot - 1


def items(h, rbfp):
    """Per product (name, N): the (rows, columns) each warp's item covers."""
    out = {}
    for name, ncols, cw in (("L1", h, 1), ("L2", 2 * h, 2), ("L3", 3 * h, 3), ("L3 reverse", 2 * h, 2),
                            ("L2 reverse", h, 1)):
        assert ncols == cw * 16 * (h // 16)
        out[(name, ncols)] = [((w & 1) * 16, (w >> 1) * 16 * cw, cw) for w in range(WARPS) if w < h // 8]
    out[("g_ea", rbfp)] = [((w & 1) * 16, (w >> 1) * 16, 1) for w in range(WARPS) if w < rbfp // 8]
    return out


def _a128(x):
    return (x + 127) // 128 * 128


def _ring(ncols, trans):
    """dual_ring_bytes: two slices of W and Z_W."""
    return 4 * (KS2 * (ncols + 8) if trans else ncols * (KS2 + 8)) * 2


def layout(h, rbfp):
    """bwd2_layout: {region: (offset, bytes)} and the total."""
    m, sld = TILE, lambda w: w + 8
    regions = [("w1", rbfp * sld(h) * 2), ("zw1", rbfp * sld(h) * 2), ("bias", 12 * h * 4),
               ("ea", 2 * m * sld(rbfp) * 2), ("zea", 2 * m * sld(rbfp) * 2), ("idx", 2 * m * 4),
               ("cm", 2 * m * 4), ("zcm", 2 * m * 4), ("p1", m * sld(h) * 2), ("pd1", m * sld(h) * 2),
               ("p2", m * sld(2 * h) * 2), ("pd2", m * sld(2 * h) * 2), ("y", 2 * m * sld(3 * h) * 2),
               ("x", max(2 * m * sld(h) * 2, _ring(3 * h, True), _ring(2 * h, False))),
               ("red", m * (3 * h // 32) * 4)]
    out, o = {}, 0
    for name, nbytes in regions:
        out[name] = (o, nbytes)
        o = _a128(o + nbytes)
    return out, o


@pytest.mark.parametrize("n,k", [(1152, 33), (1153, 33), (2496, 65), (130, 40), (7, 81)])
def test_walk_covers_every_edge_once_in_slot_order(n, k):
    rows, blocks = plan(n)
    assert blocks <= SMS
    seen = np.zeros((n, k), dtype=np.int64)
    last = np.full(n, -1)
    for _, e, row, slot in walk(n, k, rows, blocks):
        assert (row, slot) == divmod(e, k)
        assert slot > last[row]
        last[row] = slot
        seen[row, slot] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("h", [32, 64, 96, 128])
def test_items_cover_every_product_once(h):
    for rbf in (8, 32, 50, 80, 128):
        rbfp = -(-rbf // 16) * 16
        for (name, ncols), its in items(h, rbfp).items():
            cover = np.zeros((TILE, ncols), dtype=np.int64)
            for row0, col0, cw in its:
                cover[row0:row0 + 16, col0:col0 + 16 * cw] += 1
            assert (cover == 1).all(), (h, rbfp, name)


@pytest.mark.parametrize("h", [32, 64, 96, 128])
def test_shared_memory_fits_and_holds_each_region(h):
    for rbf in range(16, 129, 16):
        regions, total = layout(h, rbf)
        takes = h < 128 or rbf <= 80
        assert (total <= SMEM_MAX) == takes, (h, rbf, total)
        m, sld = TILE, lambda w: w + 8
        # y: L2's forward ring, then t2 | t2', then p3 | p3'
        assert regions["y"][1] >= max(_ring(2 * h, True), 2 * m * sld(2 * h) * 2, 2 * m * sld(3 * h) * 2)
        # x: t1 | t1', then the rings of L3's forward and of the reverse
        assert regions["x"][1] >= max(2 * m * sld(h) * 2, _ring(3 * h, True), _ring(2 * h, False), _ring(h, False))
        # the value tiles are 128-byte multiples, so each tangent tile follows at once
        assert all(m * sld(w) * 2 % 128 == 0 for w in (h, 2 * h, 3 * h))
        # 16-byte rows and weight parts in every ring (cp.async, ldmatrix)
        for ncols in (h, 2 * h, 3 * h):
            assert (ncols + 8) * 2 % 16 == 0 and KS2 * (ncols + 8) * 2 % 16 == 0 and ncols * (KS2 + 8) * 2 % 16 == 0


def _inputs(seed, h, n=40, k=33, rbf=8, cutoff=2.6):
    """f64 operands, ct and Z on a symmetric list of n atoms with k slots
    (ea and cutm from the distances), from numpy."""
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
    z = [r(*ins[name].shape) * 0.5 for name in ORDER]
    return nbl, [ins[name] for name in ORDER], r(n, 9 * h), z


def test_walk_order_sum_of_edge_terms_is_the_plain_gct_f64():
    h = 32
    nbl, inputs, ct, z = _inputs(5, h)
    n, k = nbl.idx.shape

    def gct(cutm, zcutm):
        ins = list(inputs)
        ins[2] = cutm
        zs = list(z)
        zs[2] = zcutm
        return tm.tn_messages_bwd2_reference(nbl.idx, nbl.transpose_perm, ins, ct, zs)[1]

    want = gct(inputs[2], z[2])
    terms = []  # slot s's term: cutm and its Z zero on every other slot
    for s in range(k):
        keep = torch.zeros_like(inputs[2])
        keep[:, s] = 1.0
        terms.append(gct(inputs[2] * keep, z[2] * keep))
    rows, blocks = plan(n, sms=3)  # a small grid: ragged row ranges and tiles
    assert blocks > 1 and (rows * k) % TILE
    got = torch.zeros_like(want)
    for _, _, row, slot in walk(n, k, rows, blocks):
        got[row] += terms[slot][row]
    assert want.dtype == torch.float64 and want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
