"""The launch plan and device walk of the port's fused brute neighbor search
(#7), on the CPU.

The CUDA kernel (``csrc/compaction.cu``) takes this plan on the host
(``make_plan``): one block an SM with ceil(N / SMs) receiver rows, as R =
1, 2 or 4 rows a warp, the fewest that fit 20 warps a block (past that, R
= 4 and 8 warps a block in several waves); warp w of block b owns rows (b
* W + w) * R ... + R - 1; the whole column set in one stage up to 4096
columns (64 KB of shared memory), in stages of 4096 past that.  On the
device, each stage is staged once a block as 16-byte entries (x, y, z,
molecule id or a marker that matches no row for a masked atom), padded to a
multiple of 32 with such markers; each warp sweeps the stage 32 columns a
step in ascending order, each lane one column tested against the warp's R
rows, and keeps each row's ballot word (the self pair included); then, for
each row, lane l takes words l, l + 32, ..., clears the self bit, and a
warp scan of the popcounts gives each word's first slot: a valid pair's
slot is the row's running count plus the set bits before it, stored where
it is below K.  At the end each row's empty slots point at the row with
mask False, lane 0 writes the count and, with the loop, the self column at
slot 0 (mask = the atom's validity).

The mirrors below follow that plan and walk with numpy's f32 arithmetic
(each operation rounded once, no fused multiply-add, as the kernel's
``__fsub_rn``/``__fmul_rn``/``__fadd_rn``) and are held bitwise against
``compact_neighbors_reference`` for N in {1, 31, 70, 2496}, K in {1, 12, 80,
112}, with and without the loop, on several molecules with masked atoms and
a lower cutoff above 0; the walk is also run with small stages (several per
row, padding inside the walk).  The plan covers every row once, spreads
the rows evenly over the 132 SMs at the chip's DHFR and training shapes
(one block an SM), and its shared memory fits a block.  chip_smoke.py's "compact_kernel resources" line reads
the compiled kernel's registers, spills and shared memory and fails on a
spill.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.kernels.compaction import compact_neighbors_reference
from torchmdnet_tpu_torch.ops.neighbors import _finish_rows

# the kernel's constants (csrc/compaction.cu) and an H100's limits
SMS = 132
MAX_WARPS = 20
MAX_STAGE = 4096
ENTRY_BYTES = 16
SMEM_LIMIT = 227 * 1024
INVALID_COL, INVALID_ROW = -1, -2

NS = (1, 31, 70, 2496)
KS = (1, 12, 80, 112)


def cdiv(a, b):
    return -(-a // b)


def make_plan(n, sms=SMS, stage=MAX_STAGE):
    """make_plan on a card of ``sms`` SMs (``stage`` shrinks the stage to
    walk several at a small N): (rows a warp, warps a block, columns a
    stage, blocks, dynamic shared memory a block: the stage's entries and
    each row's ballot words)."""
    need = cdiv(n, sms)
    rows, warps = next(((r, cdiv(need, r)) for r in (1, 2, 4) if cdiv(need, r) <= MAX_WARPS), (4, 8))
    stage = min(stage, n)
    stage_pad = cdiv(stage, 32) * 32
    smem = stage_pad * ENTRY_BYTES + warps * rows * (stage_pad // 32) * 4
    return rows, warps, stage, cdiv(n, rows * warps), smem


def system(n, seed, molecules=3, masked=0.1):
    """n atoms at about DHFR's density in ``molecules`` overlapping
    molecules (ids sorted, as a padded batch has them), some masked."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * max(n / 0.1, 1.0) ** (1 / 3)).astype(np.float32)
    batch = np.sort(rng.integers(0, molecules, n)).astype(np.int64)
    mask = rng.random(n) > masked
    return pos, batch, mask


def f32_square(c):
    return np.float32(c * c)


def walk(pos, batch, mask, k, cutoff_lower, cutoff_upper, loop, plan):
    """The kernel's device walk under ``plan``: (idx, mask, count) and the
    columns each row's compaction visited, in order."""
    rows, warps, stage, blocks, _ = plan
    n = pos.shape[0]
    kk = k + loop
    idx = np.full((n, kk), -7, np.int32)  # garbage a slot keeps unless written
    out_mask = np.full((n, kk), 7, np.uint8)
    cl2, cu2 = f32_square(cutoff_lower), f32_square(cutoff_upper)
    # the rows of every (block, warp, r), as the grid assigns them
    owner = np.array([(b * warps + w) * rows + r for b in range(blocks) for w in range(warps) for r in range(rows)])
    real = owner[owner < n]
    assert np.array_equal(real, np.arange(n))  # every row once
    bi = np.where(mask, batch, INVALID_ROW).astype(np.int64)
    cnt = np.zeros(n, np.int64)
    visited = [[] for _ in range(n)] if n <= 128 else None
    lanes = np.arange(32)
    for c0 in range(0, n, stage):
        cn = min(stage, n - c0)
        cpad = cdiv(cn, 32) * 32
        # the stage's entries, padded with markers that match no row
        ent_pos = np.zeros((cpad, 3), np.float32)
        ent_id = np.full(cpad, INVALID_COL, np.int64)
        ent_pos[:cn] = pos[c0:c0 + cn]
        ent_id[:cn] = np.where(mask[c0:c0 + cn], batch[c0:c0 + cn], INVALID_COL)
        # the sweep: one ballot word a row a step of 32 columns (the self
        # pair included)
        nw = cpad // 32
        words = np.zeros((n, nw), np.uint64)
        for s in range(0, cpad, 32):
            d = pos[:, None, :] - ent_pos[None, s:s + 32, :]  # f32, rounded once
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
            valid = (d2 < cu2) & (d2 >= cl2) & (ent_id[s:s + 32][None, :] == bi[:, None])
            words[:, s // 32] = (valid.astype(np.uint64) << lanes.astype(np.uint64)).sum(1)
        # the compaction: lane l holds words l, l + 32, ...; the self bit
        # cleared; each word's first slot from a warp scan of the popcounts
        for i in range(n):
            base = int(cnt[i])
            self_col = i - c0
            for w0 in range(0, nw, 32):
                ws = [int(words[i, w]) if w < nw else 0 for w in range(w0, w0 + 32)]
                if 0 <= self_col and (self_col >> 5) - w0 in range(32):
                    ws[(self_col >> 5) - w0] &= ~(1 << (self_col & 31))
                counts = [bin(x).count("1") for x in ws]
                inc = np.cumsum(counts)
                for lane, bits in enumerate(ws):
                    slot = base + int(inc[lane]) - counts[lane]
                    while bits and slot < k:
                        b = (bits & -bits).bit_length() - 1
                        bits &= bits - 1
                        idx[i, loop + slot] = c0 + ((w0 + lane) << 5) + b
                        out_mask[i, loop + slot] = 1
                        slot += 1
                    if visited is not None and w0 + lane < nw:
                        visited[i].extend(range(c0 + ((w0 + lane) << 5), min(c0 + ((w0 + lane + 1) << 5), c0 + cn)))
                base += int(inc[-1])
            cnt[i] = base
    for i in range(n):
        filled = min(int(cnt[i]), k)
        idx[i, loop + filled:] = i
        out_mask[i, loop + filled:] = 0
        if loop:
            idx[i, 0] = i
            out_mask[i, 0] = mask[i]
    return idx, out_mask.astype(bool), cnt.astype(np.int32), visited


def reference(pos, batch, mask, **kw):
    out = compact_neighbors_reference(torch.as_tensor(pos), torch.as_tensor(batch), torch.as_tensor(mask), **kw)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_walk_matches_the_plain_version(n, k, loop):
    pos, batch, mask = system(n, seed=n + k)
    kw = dict(k=k, cutoff_lower=0.0, cutoff_upper=5.0, loop=loop)
    got = walk(pos, batch, mask, plan=make_plan(n), **kw)
    want = reference(pos, batch, mask, **kw)
    for a, b in zip(got[:3], want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", [32, 100, 1000])
def test_walk_in_stages_with_a_lower_cutoff(stage):
    """Several stages a row (padding inside the walk where a stage is not a
    multiple of 32), a lower cutoff, rows truncated at K with their count
    kept, masked atoms, and the columns visited once each in ascending
    order."""
    n, k = 700, 8
    pos, batch, mask = system(n, seed=stage, molecules=4)
    kw = dict(k=k, cutoff_lower=1.5, cutoff_upper=5.0, loop=True)
    plan = make_plan(n, stage=stage)
    idx, out_mask, count, _ = walk(pos, batch, mask, plan=plan, **kw)
    want = reference(pos, batch, mask, **kw)
    for a, b in zip((idx, out_mask, count), want):
        np.testing.assert_array_equal(a, b)
    assert int(count.max()) > k  # some rows are truncated
    assert not out_mask[~mask].any() and not count[~mask].any()
    small = system(70, seed=1)
    _, _, _, visited = walk(*small, plan=make_plan(70, stage=stage % 64 or 32), **kw)
    assert all(v == list(range(70)) for v in visited)


@pytest.mark.parametrize("sms,rows,warps", [(132, 1, 3), (10, 2, 15), (4, 4, 19), (2, 4, 8)])
def test_every_plan_gives_the_same_list(sms, rows, warps):
    """Each of the plan's forms, reached through the rows an SM must take:
    one row a warp, two, four, and four in 8-warp blocks over several
    waves."""
    n = 300
    pos, batch, mask = system(n, seed=rows * warps)
    kw = dict(k=40, cutoff_lower=0.0, cutoff_upper=5.0, loop=True)
    want = reference(pos, batch, mask, **kw)
    plan = make_plan(n, sms=sms)
    assert plan[:2] == (rows, warps)
    got = walk(pos, batch, mask, plan=plan, **kw)
    for a, b in zip(got[:3], want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2496, 2304])
def test_grid_spreads_the_rows_over_every_sm(n):
    """DHFR (the row shape and the MD build share N: 132 blocks of 19 rows)
    and a training batch of 128 molecules of 18 atoms (128 blocks of 18):
    one wave, no SM with more than ceil(N / 132) rows."""
    rows, warps, stage, blocks, smem = make_plan(n)
    assert blocks <= SMS and rows * warps == cdiv(n, SMS) and warps <= MAX_WARPS
    assert blocks == SMS if n == 2496 else blocks == 128
    assert stage == n and smem <= 48 * 1024  # one stage, no opt-in needed


@pytest.mark.parametrize("n", [1, 33, 4096, 4097, 16000, 100_000])
def test_plan_fits_a_block(n):
    rows, warps, stage, blocks, smem = make_plan(n)
    assert smem <= SMEM_LIMIT and stage <= MAX_STAGE and blocks * rows * warps >= n
    assert cdiv(n, stage) == (1 if n <= MAX_STAGE else cdiv(n, MAX_STAGE))
    assert warps <= MAX_WARPS and (blocks <= SMS or (rows, warps) == (4, 8))


def test_plain_loop_equals_the_concatenated_form():
    """``loop=True`` prepends the self column to the list without it, as
    ``neighbor_list`` did with an arange and two concatenations."""
    pos, batch, mask = system(70, seed=5)
    t = (torch.as_tensor(pos), torch.as_tensor(batch), torch.as_tensor(mask))
    kw = dict(k=12, cutoff_lower=0.5, cutoff_upper=4.0)
    idx, m, c = compact_neighbors_reference(*t, **kw)
    lidx, lm, lc = compact_neighbors_reference(*t, loop=True, **kw)
    ar = torch.arange(70, dtype=torch.int32)[:, None]
    assert torch.equal(lidx, torch.cat([ar, idx], dim=1)) and torch.equal(lm, torch.cat([t[2][:, None], m], dim=1))
    assert torch.equal(lc, c)
    # _finish_rows pads the same way for a K past the candidates
    first = torch.full((70, 3), 70)
    fidx, fmask = _finish_rows(first, 70, 5, True, t[2])
    assert torch.equal(fidx[:, 1:], ar.expand(70, 5)) and not fmask[:, 1:].any()
