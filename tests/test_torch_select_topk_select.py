"""The selection algorithm of the port's k-smallest kernel (#6), mirrored on the CPU.

The CUDA kernel (``select_topk_kernel``, ``csrc/select_topk.cu``) gives each
row to one warp, lane l holding columns l, l + 32, ... in registers.  It
finds the threshold, the row's k-th smallest entry: the sentinel when one
count finds fewer than k real keys, else by a bitwise search on the keys'
unsigned offsets from the row minimum (one warp count a bit, over 32 -
clz(sentinel - min) bits); compacts the real keys at or below it in row
order with ballot/popc prefixes; ranks each compacted key by the count of
smaller ones; and stores the ranked keys, then the sentinel.  ``select``
below follows those steps lane by lane.  It is held bitwise to
``select_topk_reference`` (sort the row, keep k columns) on the cases where
the steps could go wrong: ragged widths and an all-sentinel row, fewer real
keys than k, exactly k and k = W, keys 0 and sentinel - 1, a sentinel that
is a power of two and one that is not, negative keys, and the STMV skin
shape's sentinel (30,336).
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk_reference

LANES = 32


def _lanes(row):
    """The row as the warp holds it: (KPL, 32), register i of lane l holding
    column l + 32 i; None past the row."""
    kpl = -(-len(row) // LANES)
    regs = [[None] * LANES for _ in range(kpl)]
    for c, x in enumerate(row):
        regs[c // LANES][c % LANES] = int(x)
    return regs


def select(keys, k, sentinel):
    """The kernel's steps on each row of ``keys`` (N, W) int32: (out (N, k)
    int32, the search steps each row took)."""
    n, w = keys.shape
    out = np.empty((n, k), dtype=np.int32)
    steps = []
    for i in range(n):
        regs = _lanes(keys[i])
        lo = min(x for reg in regs for x in reg if x is not None)  # the warp minimum
        umax = 2**32 - 1
        u = [[umax if x is None else (x - lo) & umax for x in reg] for reg in regs]
        top = (sentinel - lo) & umax
        def count_below(cand):  # per-lane counts, then the warp sum
            return sum(sum(reg[lane] < cand for reg in u) for lane in range(LANES))

        # the threshold: the largest offset with fewer than k keys below it;
        # the sentinel's when fewer than k keys are real (one count)
        t, nsteps = top, 0
        if count_below(top) >= k:
            t = 0
            for b in range(top.bit_length() - 1, -1, -1):
                cand = t | (1 << b)
                if count_below(cand) < k:
                    t = cand
                nsteps += 1
        steps.append(nsteps)
        # compaction in row order: register by register, lanes by ballot prefix
        sel, m = [None] * k, 0
        for reg in u:
            p = [d <= t and d != top for d in reg]
            for lane in range(LANES):
                at = m + sum(p[:lane])
                if p[lane] and at < k:
                    sel[at] = (reg[lane] + lo) & umax
            m += sum(p)
        m = min(m, k)
        sel = [x - 2**32 if x >= 2**31 else x for x in sel[:m]]
        # ranks: the count of smaller compacted keys
        ordered = [None] * m
        for x in sel:
            ordered[sum(y < x for y in sel)] = x
        assert None not in ordered  # unique keys: the ranks are distinct
        out[i] = ordered + [sentinel] * (k - m)
    return out, steps


def _unique_keys(rng, n, w, sentinel, invalid_share):
    """(n, w) int32 keys, unique per row in [0, sentinel), a share of them
    replaced by the sentinel."""
    keys = np.argsort(rng.random((n, sentinel)), axis=1)[:, :w].astype(np.int32)
    keys[rng.random((n, w)) < invalid_share] = sentinel
    return keys


def _check(keys, k, sentinel):
    got, steps = select(keys, k, sentinel)
    want = select_topk_reference(torch.as_tensor(keys), k).numpy()
    np.testing.assert_array_equal(got, want)
    # a bounded look at each key: no search where fewer than k keys are real,
    # else 32 - clz(sentinel - min) steps, whatever k
    mins = keys.astype(np.int64).min(axis=1)
    real = (keys < sentinel).sum(axis=1)
    assert all(s == (int(sentinel - lo).bit_length() if r >= k else 0) for s, lo, r in zip(steps, mins, real))
    return got


def test_ragged_width_and_an_all_sentinel_row():
    rng = np.random.default_rng(0)
    keys = _unique_keys(rng, 9, 45, 5000, 0.3)
    keys[2] = 5000
    keys[3, 4:] = 5000  # four real keys, fewer than k
    got = _check(keys, 20, 5000)
    assert (got[2] == 5000).all() and (got[3, 4:] == 5000).all()


@pytest.mark.parametrize("real", [19, 20, 21])
def test_fewer_exactly_and_more_real_keys_than_k(real):
    rng = np.random.default_rng(real)
    keys = np.full((6, 70), 700, dtype=np.int32)
    for i in range(6):
        keys[i, rng.choice(70, real, replace=False)] = rng.choice(700, real, replace=False)
    got = _check(keys, 20, 700)
    assert ((got < 700).sum(axis=1) == min(real, 20)).all()


def test_k_equal_to_w():
    rng = np.random.default_rng(1)
    keys = _unique_keys(rng, 5, 37, 400, 0.4)
    _check(keys, 37, 400)


def test_keys_zero_and_sentinel_minus_one():
    rng = np.random.default_rng(2)
    keys = _unique_keys(rng, 6, 64, 1000, 0.5)
    keys[:, 0] = 0
    keys[:, 63] = 999
    got = _check(keys, 64, 1000)
    assert (got[:, 0] == 0).all()
    _check(keys, 10, 1000)


@pytest.mark.parametrize("sentinel", [4096, 4097, 5000])
def test_sentinel_power_of_two_or_not(sentinel):
    rng = np.random.default_rng(sentinel)
    keys = _unique_keys(rng, 8, 100, sentinel, 0.4)
    keys[0, :3] = [0, sentinel - 1, 2048]
    _check(keys, 30, sentinel)


def test_negative_keys():
    """Any int32 keys below the sentinel: the offsets from the row minimum
    keep their order (here 32 search steps)."""
    rng = np.random.default_rng(4)
    spread = np.argsort(rng.random((6, 10**4)), axis=1)[:, :50].astype(np.int64)
    keys = (-2**31 + 2000 + spread * 400_000).astype(np.int32)  # unique per row, below 2^31 - 100
    keys[rng.random(keys.shape) < 0.3] = 2**31 - 100
    keys[0, 0] = -2**31
    _check(keys, 12, 2**31 - 100)


def test_stmv_skin_shape_sentinel():
    """The STMV skin build's sentinel (N = 30,336), W = 27 x 38, k = 112: a
    15-step search."""
    rng = np.random.default_rng(5)
    keys = _unique_keys(rng, 4, 1026, 30336, 0.85)
    keys[1] = 30336
    keys[1, 500:700] = np.arange(30336 - 200, 30336)  # more real keys than k, up to sentinel - 1
    _check(keys, 112, 30336)
