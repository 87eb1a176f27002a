"""The port's k-smallest selection (kernel #6) held against the JAX package's, on the CPU.

``select_topk_reference`` (the plain version the port's wrapper runs for CPU
tensors, and the yardstick of the CUDA kernel on the card) is compared with
JAX's Pallas ``select_topk`` in interpret mode, as tests/test_cell_list.py
runs it, on seeded numpy keys: unique real keys per row, the sentinel in the
other slots, widths that are not a multiple of 32, k above and below a row's
real-key count, an all-sentinel row.  The outputs are integers: bitwise
equal.  The CUDA kernel is held against the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.pallas.select_topk import select_topk as j_select_topk
from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk, select_topk_reference

SENTINEL = 300


def _keys(seed, n, w, invalid_share):
    """(n, w) int32 keys, unique per row below SENTINEL, a share replaced by
    it; row 0 holds no real key, row 1 three."""
    rng = np.random.default_rng(seed)
    keys = np.argsort(rng.random((n, SENTINEL)), axis=1)[:, :w].astype(np.int32)
    keys[rng.random((n, w)) < invalid_share] = SENTINEL
    keys[0] = SENTINEL
    keys[1, 3:] = SENTINEL
    return keys


@pytest.mark.parametrize("n,w,k", [(40, 45, 20), (33, 32, 18), (17, 91, 50)])
def test_plain_version_matches_jax_select_topk(n, w, k):
    keys = _keys(n + w, n, w, 0.4)
    real = (keys < SENTINEL).sum(axis=1)
    assert real.min() < k < real.max()  # rows below and above k real keys
    want = np.asarray(j_select_topk(jnp.asarray(keys), k, SENTINEL, interpret=True))
    got = select_topk_reference(torch.as_tensor(keys), k)
    np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes the plain version, and counts no kernel launch
    before = select_topk.launches
    assert torch.equal(select_topk(torch.as_tensor(keys), k, SENTINEL), got)
    assert select_topk.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    keys = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        select_topk(keys.long(), 2, 9)
    with pytest.raises(ValueError, match=r"\(N, W\)"):
        select_topk(keys[0], 2, 9)
    with pytest.raises(ValueError, match="contiguous"):
        select_topk(keys.t(), 2, 9)
    for k in (0, 9):
        with pytest.raises(ValueError, match="k <= W"):
            select_topk(keys, k, 9)
    with pytest.raises(ValueError, match="int32"):
        select_topk(keys, 2, 2**31)
