"""The walk of the port's fused Transformer forward (#11) over its edges, on
the CPU.

The CUDA forward (``t_fwd_kernel``, ``csrc/t_message.cu``) gives each row
group of H threads a contiguous range of receiver rows, cuts the group's
flattened slots (i*K + k) into chunks of 16 that run across rows, and walks
each chunk two edges at a time, tracking the receiver row and slot of each
edge itself (``new_a``/``new_b``) and keeping each row's sum sequential in
one thread.  ``plan``/``walk`` mirror its host plan (``plan_pass`` for the
forward: of the row-group counts from the most that fit 768 threads (at
most 15) and the shared memory down to half that, the one that gives an SM
the fewest rows, then the most groups; rows per group so that the grid
fills every SM about once) and that walk.  Here:

- at ragged N and K (K = 33, 40, 81; N not a multiple of the row groups, and
  fewer rows than the card has groups) the walk visits every (row, slot)
  exactly once, in ascending slot order per row, each edge's tracked row
  and slot equal its flattened index, and the receiver row each edge reads
  q from is its own;
- in f64, summing ``t_messages_reference``'s per-edge terms (each slot
  alone: cutm zero elsewhere) in the walk's order gives the plain output,
  for every distance influence.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.kernels import t_message as tm
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, neighbor_list, transpose_perm

# the kernel's constants (csrc/common.cuh, csrc/t_message.cu) and an H100's limits
KC = 16
MAX_GROUPS = 15
FWD_MAX_THREADS = 768
SMS = 132
SMEM_MAX = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin

ORDER = ["q", "k", "v", "ea", "cutm", "wdk", "bdk", "wdv", "bdv"]
FILTERS = {"both": (), "keys": ("wdv", "bdv"), "values": ("wdk", "bdk"),
           "none": ("wdk", "bdk", "wdv", "bdv")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _align32(x):
    return (x + 31) // 32 * 32


def _fwd_smem(h, rbf, groups):
    """``pass_layout(h, heads, rbf, groups, FWD).total``: the filter weights
    (2H, RBFP + 8) bf16, then per group two ea buffers, the (KC, 2H + 8)
    filter tile, two buffers of ids (and receiver rows) and of cutm."""
    ldw = (rbf + 15) // 16 * 16 + 8
    stride = 0
    for nbytes in (2 * KC * ldw * 2, KC * (2 * h + 8) * 2, 2 * 2 * KC * 4, 2 * KC * 4, 0):
        stride = _align32(stride + nbytes)
    return _align32(2 * h * ldw * 2) + groups * stride


def plan(n, h, rbf, sms=SMS, smem_max=SMEM_MAX):
    """(row groups a block, contiguous rows a group, blocks), as plan_pass."""
    most = next(g for g in range(min(MAX_GROUPS, FWD_MAX_THREADS // h), 0, -1)
                if _fwd_smem(h, rbf, g) <= smem_max)
    # the first of equals: the most groups
    groups = min((g for g in range(most, 0, -1) if 2 * g >= most), key=lambda g: g * -(-n // (g * sms)))
    iters = -(-n // (groups * sms))
    return groups, iters, -(-n // (groups * iters))


def walk(n, k, groups, iters, blocks):
    """The edges in the order each group's per-edge loop visits them: yields
    (block, group, edge, row, slot, q_row) with the row and slot the loop
    tracks and the row whose q it multiplies."""
    for b in range(blocks):
        for g in range(groups):
            r0 = (b * groups + g) * iters
            r1 = min(r0 + iters, n)
            if r0 >= r1:
                continue
            eb, ne = r0 * k, (r1 - r0) * k
            i, slot = r0, 0
            for ch in range(-(-ne // KC)):
                kn = min(KC, ne - ch * KC)
                for kc in range(0, kn, 2):
                    two = kc + 1 < kn
                    new_a = slot == k
                    new_b = two and (1 if new_a else slot + 1) == k
                    qa = i + 1 if new_a else i
                    qb = i + 1 + new_a if new_b else qa
                    for x in range(2 if two else 1):
                        if new_b if x else new_a:
                            i += 1
                            slot = 0
                        slot += 1
                        yield b, g, eb + ch * KC + kc + x, i, slot - 1, qb if x else qa


@pytest.mark.parametrize("n,k,h", [(2491, 81, 128), (2491, 33, 256), (1153, 40, 96), (37, 33, 128),
                                   (700, 40, 32), (1, 81, 64)])
def test_walk_covers_every_slot_once_in_order(n, k, h):
    groups, iters, blocks = plan(n, h, rbf=50)
    assert groups * h <= FWD_MAX_THREADS and blocks <= SMS
    seen = np.zeros((n, k), dtype=np.int64)
    last = np.full(n, -1)
    for _, _, e, row, slot, q_row in walk(n, k, groups, iters, blocks):
        assert (row, slot) == divmod(e, k) and q_row == row
        assert slot > last[row], "slots of a row out of order"
        last[row] = slot
        seen[row, slot] += 1
    assert (seen == 1).all()


def _inputs(seed, k, h, heads, rbf=8, n=40):
    """f64 operands on a symmetric list of n atoms with k slots, from numpy."""
    rng = np.random.RandomState(seed)
    pos = torch.as_tensor(rng.uniform(0, 4.0, (n, 3)))
    nbl = neighbor_list(pos, k=k - 1, cutoff_upper=2.2, loop=True, strategy="brute")  # + the self slot
    nbl.raise_on_overflow("test")
    assert tuple(nbl.idx.shape) == (n, k)
    _, dist = edge_geometry_components(pos, nbl)
    r = lambda *s: torch.as_tensor(rng.randn(*s))
    ins = dict(q=r(n, h), k=r(n, h), v=r(n, h), ea=r(n, k, rbf) * 0.3,
               cutm=0.5 * (torch.cos(dist * np.pi / 2.2) + 1) * nbl.mask.double(),
               wdk=r(rbf, h) * 0.3, bdk=r(1, h) * 0.1, wdv=r(rbf, h) * 0.3, bdv=r(1, h) * 0.1)
    return nbl.idx, transpose_perm(nbl.idx), ins


@pytest.mark.parametrize("influence", ["both", "keys", "values", "none"])
def test_walk_order_sum_of_edge_terms_is_the_plain_output_f64(influence):
    n, k, h, heads = 37, 33, 32, 4
    idx, perm, ins = _inputs(3, k, h, heads, n=n)
    ops = {name: None if name in FILTERS[influence] else a for name, a in ins.items()}

    def out(cutm):
        args = [cutm if name == "cutm" else ops[name] for name in ORDER]
        return tm.t_messages_reference(idx, *args, heads=heads, perm=perm)

    want = out(ins["cutm"])
    terms = []  # slot s's messages: cutm zero on every other slot
    for s in range(k):
        only = torch.zeros_like(ins["cutm"])
        only[:, s] = ins["cutm"][:, s]
        terms.append(out(only))
    # one SM's grid: chunks across rows, and the last group's range ragged
    groups, iters, blocks = plan(n, h, rbf=8, sms=1)
    assert iters > 1 and n % (groups * iters)
    got = torch.zeros_like(want)
    for _, _, _, row, slot, _ in walk(n, k, groups, iters, blocks):
        got[row] += terms[slot][row]
    assert want.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
