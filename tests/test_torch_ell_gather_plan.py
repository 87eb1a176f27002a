"""The launch plans and device walks of the port's ELL gather (#4) and
transpose-sum (#5), on the CPU.

The CUDA kernels (``csrc/ell_gather.cu``) take these plans on the host:

- #4 (``gather_plan``): chunks of 16 bytes (8 bf16) where the width is a
  multiple of 8 and both pointers are 16-byte aligned, else one bf16; cw =
  min(chunks a row, 256) threads across a row, rpb = 256 // cw rows a block
  step; U = 4 rows a thread unless four would leave SMs without a tile, else
  1; one tile of rpb * U rows a block.  Thread (ry, cx) of block b copies
  chunks cx, cx + cw, ... of rows b * rpb * U + u * rpb + ry, its U source
  rows loaded first (a row past the end reads the last row's source and
  stores nothing).
- #5 (``sum_plan``): V = 2 channels a lane (4 bytes) where the width is
  even and both pointers 4-byte aligned, else 1; a warp owns span w % spans
  (32 V channels) of atom w // spans; 8 warps a block, halved while the
  grid would have fewer blocks than SMs.  Each lane walks the atom's K
  slots through a register ring of 16 rows: the first 16 (clamped to the
  last slot) loaded up front; while base + 16 < K, the adds of slots base ..
  base + 15 each followed by the refill of slot base + 16 + u (clamped), its
  slot id shuffled from the lane of an id register that holds 32 slot ids
  (one a lane, the next 32 loaded a chunk ahead); then the adds of the
  slots left.

The mirrors below follow those host plans and device loops.  Here, for N in
{1, 168, 2496}, K in {1, 32, 80, 112} and F in {13, 128, 384, 1152}:

- every (row, chunk) of #4 and every (atom, channel) of #5 is covered
  exactly once, and each of #4's stores copies its own row's source;
- each of #5's sums walks the slots in ascending order with each ring
  entry holding the row of the slot it adds, and the walk-order f32 sum of
  random bf16 rows is bitwise a sequential numpy f32 sum rounded once;
- the wide chunks (#4's 16 bytes, #5's 4) are taken only for rows and
  pointers aligned to them;
- the grid reaches the 132 SMs wherever the rows or atoms allow.

Neither kernel asks for shared memory: their rows in flight are in
registers.  chip_smoke.py's "ell_gather kernel resources" line reads the
registers, spills and shared memory of the compiled kernels and fails on a
spill.
"""

import numpy as np
import pytest
import torch

# the kernels' constants (csrc/ell_gather.cu) and an H100's limits
SMS = 132
GATHER_THREADS = 256
UNROLL = 4
RING = 16
SUM_WARPS = 8

NS = (1, 168, 2496)
KS = (1, 32, 80, 112)
FS = (13, 128, 384, 1152)


def cdiv(a, b):
    return -(-a // b)


def gather_plan(rows, f, align=16, sms=SMS):
    """gather_plan: (v, cw, rpb, unroll, blocks), one tile a block."""
    v = 8 if f % 8 == 0 and align % 16 == 0 else 1
    fv = f // v
    cw = min(fv, GATHER_THREADS)
    rpb = GATHER_THREADS // cw
    unroll = UNROLL if cdiv(rows, rpb * UNROLL) >= sms else 1
    return v, cw, rpb, unroll, cdiv(rows, rpb * unroll)


def sum_plan(n, f, align=16, sms=SMS):
    """sum_plan: (v, spans, warps a block, blocks)."""
    v = 2 if f % 2 == 0 and align % 4 == 0 else 1
    spans = cdiv(f, 32 * v)
    tasks = n * spans
    warps = SUM_WARPS
    while warps > 1 and cdiv(tasks, warps) < sms:
        warps //= 2
    return v, spans, warps, cdiv(tasks, warps)


def gather_walk(idx, f):
    """gather_rows_kernel over all blocks at once: the rows that the
    threads with cx = 0 store (every cx of a row stores with them) with the
    source rows every thread copies for them, and each thread's chunks."""
    rows = idx.size
    v, cw, rpb, unroll, blocks = gather_plan(rows, f)
    tid = np.arange(cw * rpb)
    cx, ry = tid % cw, tid // cw
    chunks = [list(range(c, f // v, cw)) for c in cx]  # each thread's c loop
    # (block, u, thread): row r0 + u * rpb with r0 = block * rpb * U + ry
    r = (np.arange(blocks)[:, None, None] * (rpb * unroll) + np.arange(unroll)[None, :, None] * rpb
         + ry[None, None, :])
    src = idx[np.minimum(r, rows - 1)]  # a row past the end reads the last row's source
    for y in range(rpb):  # every thread of a row copies the same source row
        assert (src[..., ry == y] == src[..., ry == y][..., :1]).all()
    keep = (r < rows) & (cx == 0)
    return (v, cw, rpb, unroll, blocks), r[keep], src[keep], chunks


def ring_walk(k, ring_rows=RING):
    """One lane's ring (transpose_sum_rows_kernel): the slots in the order
    they are added, each with the slot whose row its ring entry holds.  The
    slot ids come 32 at a time, one a lane: ``cur`` (the 32 the refills take
    now) and ``nxt`` (the next 32, loaded a chunk ahead); a refill takes lane
    ``from % 32 + u`` of ``cur``."""
    last = k - 1
    cur = [min(lane, last) for lane in range(32)]
    nxt = [min(32 + lane, last) for lane in range(32)]
    ring = [cur[u] for u in range(ring_rows)]  # the slot each entry's row belongs to
    added = []
    base = 0
    while base + ring_rows < k:
        start = base + ring_rows
        if start % 32 == 0:
            cur, nxt = nxt, [min(start + 32 + lane, last) for lane in range(32)]
        for u in range(ring_rows):
            added.append((base + u, ring[u]))
            ring[u] = cur[start % 32 + u]
        base += ring_rows
    for u in range(ring_rows):
        if base + u < k:
            added.append((base + u, ring[u]))
    return added


def sum_walk(n, f):
    """Each warp's (atom, channels) in transpose_sum_rows_kernel: the
    (atom, channel) pairs the active lanes store."""
    v, spans, warps, blocks = sum_plan(n, f)
    task = np.arange(blocks * warps)
    task = task[task < n * spans]  # the warps past the tasks return
    j, span = task // spans, task % spans
    c = (span[:, None] * 32 + np.arange(32)[None, :]) * v  # (tasks, lanes)
    ch = c[..., None] + np.arange(v)  # each lane's V channels
    active = (c < f)[..., None] & np.ones(v, bool)
    atoms = np.broadcast_to(j[:, None, None], ch.shape)
    return (v, spans, warps, blocks), atoms[active], ch[active]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_gather_walk_covers_each_row_and_chunk_once(n, k):
    rng = np.random.default_rng(n * 1000 + k)
    idx = rng.integers(0, n, size=n * k).astype(np.int32)
    for f in FS:
        (v, cw, rpb, unroll, blocks), rows, src, chunks = gather_walk(idx, f)
        assert cw * rpb <= GATHER_THREADS
        np.testing.assert_array_equal(np.sort(rows), np.arange(n * k))  # each row once
        np.testing.assert_array_equal(src, idx[rows])  # its own source
        flat = np.sort(np.concatenate([np.asarray(c, int) for c in chunks[:cw]]))
        np.testing.assert_array_equal(flat, np.arange(f // v))  # each chunk of a row once
        # every thread with a given ry takes one cx: the chunk sets of a row
        assert all(chunks[t] == chunks[t % cw] for t in range(cw * rpb))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("f", FS)
def test_sum_walk_covers_each_atom_channel_once(n, f):
    (v, spans, warps, blocks), atoms, ch = sum_walk(n, f)
    key = atoms.astype(np.int64) * f + ch
    np.testing.assert_array_equal(np.sort(key), np.arange(n * f))
    assert v * 32 * spans >= f > v * 32 * (spans - 1)


@pytest.mark.parametrize("ring_rows", (8, RING))
@pytest.mark.parametrize("k", KS + (2, 31, 33, 64, 65, 200))
def test_ring_adds_slots_in_order(k, ring_rows):
    """At the kernel's ring of 16 rows, and at 8, another divisor of the
    warp that its code takes."""
    added = ring_walk(k, ring_rows)
    assert [s for s, _ in added] == list(range(k))
    assert all(s == held for s, held in added)  # each entry holds the row of the slot it adds


@pytest.mark.parametrize("k", KS)
def test_ring_sum_is_sequential_f32_sum(k):
    """The walk-order f32 sum of bf16 rows, rounded once, against numpy's
    sequential f32 sum of the same rows."""
    rng = np.random.default_rng(k)
    n, f = 16, 128
    g = torch.as_tensor(rng.normal(size=(n * k, f)).astype(np.float32)).to(torch.bfloat16)
    perm = np.concatenate([rng.permutation(n * k)])
    for j in range(n):
        slots = perm[j * k:(j + 1) * k]
        acc = torch.zeros(f, dtype=torch.float32)
        for s, held in ring_walk(k):
            acc = acc + g[int(slots[held])].float()
        got = acc.to(torch.bfloat16)
        want = np.zeros(f, np.float32)
        for s in range(k):
            want = (want + g[int(slots[s])].float().numpy()).astype(np.float32)
        assert torch.equal(got, torch.as_tensor(want).to(torch.bfloat16))


@pytest.mark.parametrize("f", FS + (130, 8, 4, 2))
def test_wide_chunks_only_where_aligned(f):
    for align in (2, 4, 8, 16):
        v = gather_plan(1000, f, align)[0]
        assert (v == 8) == (f % 8 == 0 and align == 16)
        v = sum_plan(1000, f, align)[0]
        assert (v == 2) == (f % 2 == 0 and align >= 4)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_grid_fills_the_sms(n, k):
    for f in FS:
        v, cw, rpb, unroll, blocks = gather_plan(n * k, f)
        assert blocks >= min(SMS, cdiv(n * k, rpb))
        assert unroll == 1 or blocks >= SMS
        v, spans, warps, blocks = sum_plan(n, f)
        assert blocks >= min(SMS, n * spans)
    # GN-aspirin training (N 168, K 32, F 128): 168 two-warp blocks for #5
    # (two spans an atom), 336 blocks of 16 rows for #4
    assert sum_plan(168, 128) == (2, 2, 2, 168)
    assert gather_plan(168 * 32, 128)[3:5] == (1, 336)
