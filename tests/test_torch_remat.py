"""Remat's save-list for the fused edge kernels (``ops/kernels/save_list.py``)
on the CPU.

The fused ET, Transformer and TensorNet models (2 layers, bf16 messages),
their calls routed through the autograd Functions with every kernel launch
replaced by a counting plain twin (``test_torch_force_grad_jvp``'s
``tangent_free_kernels`` and ``route_models_through_functions``):

- with ``remat``, energies and forces equal those without bitwise, and a
  force-loss ``Trainer`` step's gradients by grad-of-grad and in jvp mode
  within REMAT_TOL of each tensor's largest value (measured: bitwise);
- each kernel launches as often with remat as without (a force evaluation L
  forwards and L backwards; a gradgrad step (L, 2L, L), a jvp step (3L, 3L,
  0)), and every recomputation of a layer is served its forward's outputs by
  replay: L replays per backward pass;
- a planted fault, a replayed output perturbed by 1e-3 of itself, moves the
  gradients far beyond REMAT_TOL (measured: 1.0e-3 to 1.3e-3) and ET's and
  TensorNet's forces (8.7e-5, 3.2e-6); the Transformer's forces cannot see
  it: its layer is linear in the aggregate, whose value only the output
  projection's weight gradient reads.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_force_grad_jvp import (
    BASE,
    FUSED,
    _batch,
    _gap,
    _step_grads,
    route_models_through_functions,
    tangent_free_kernels,
)
from torchmdnet_tpu_torch import create_model
from torchmdnet_tpu_torch.data.batch import spatial_sort
from torchmdnet_tpu_torch.ops.kernels import save_list

REMAT_TOL = 1e-5
FAULT = 1e-3
LAYERS = BASE["num_layers"]
KERNEL = {"et": "et_message_fwd", "t": "t_message_fwd", "tn": "tn_message_fwd"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(family, remat):
    return dict(BASE, precision=32, bf16_messages=True, max_z=128 if family == "tn" else 100, remat=remat,
                **FUSED[family])


def _fused_batch():
    return spatial_sort(_batch(np.float32), cell=5.0)[0]


def _forces(family, remat):
    model = create_model(_args(family, remat), device="cpu", seed=1)
    return model.energy_and_forces(_fused_batch())


def plant_replay_fault(monkeypatch):
    """Every output served by replay perturbed by FAULT of itself."""
    served = save_list.fused_output

    def perturbed(name, launch):
        out = served(name, launch)
        frames = save_list._active()
        if frames and frames[-1].replay:
            out = tuple(t * (1 + FAULT) for t in out) if isinstance(out, tuple) else out * (1 + FAULT)
        return out

    monkeypatch.setattr(save_list, "fused_output", perturbed)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_remat_forces_replay(monkeypatch, family):
    counts = tangent_free_kernels(monkeypatch, family)
    route_models_through_functions(monkeypatch)
    y0, f0 = _forces(family, False)
    assert tuple(counts.values()) == (LAYERS, LAYERS, 0)
    counts.update(dict.fromkeys(counts, 0))
    save_list.reset_replays()
    y1, f1 = _forces(family, True)
    assert tuple(counts.values()) == (LAYERS, LAYERS, 0)
    assert save_list.replays == {KERNEL[family]: LAYERS}  # one backward: each layer recomputed once
    print(f"{family}: remat against no remat, energy {_rel(y1, y0):.3e}, forces {_rel(f1, f0):.3e}")
    assert torch.equal(y1, y0) and torch.equal(f1, f0)


@pytest.mark.parametrize("mode", ["gradgrad", "jvp"])
@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_remat_step_replay(monkeypatch, tmp_path, family, mode):
    counts = tangent_free_kernels(monkeypatch, family)
    route_models_through_functions(monkeypatch)
    batch = _fused_batch()
    want, want_losses = _step_grads(_args(family, False), mode, batch, tmp_path)
    launches = tuple(counts.values())
    assert launches == ((LAYERS, 2 * LAYERS, LAYERS) if mode == "gradgrad" else (3 * LAYERS, 3 * LAYERS, 0))
    counts.update(dict.fromkeys(counts, 0))
    save_list.reset_replays()
    got, losses = _step_grads(_args(family, True), mode, batch, tmp_path)
    assert tuple(counts.values()) == launches
    # gradgrad: the forces' backward and the loss's; jvp: the three passes'
    backwards = 2 if mode == "gradgrad" else 3
    assert save_list.replays == {KERNEL[family]: backwards * LAYERS}
    gap = _gap(got, want)
    print(f"{family} {mode}: remat against no remat, largest gradient gap {gap:.3e}")
    assert gap <= REMAT_TOL
    np.testing.assert_allclose(losses, want_losses, rtol=REMAT_TOL)


@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_remat_planted_replay_fault_fails(monkeypatch, tmp_path, family):
    tangent_free_kernels(monkeypatch, family)
    route_models_through_functions(monkeypatch)
    batch = _fused_batch()
    want, _ = _step_grads(_args(family, False), "gradgrad", batch, tmp_path)
    _, f0 = _forces(family, False)
    plant_replay_fault(monkeypatch)
    got, _ = _step_grads(_args(family, True), "gradgrad", batch, tmp_path)
    _, f1 = _forces(family, True)
    gaps = _gap(got, want), _rel(f1, f0)
    print(f"{family}: replay perturbed by {FAULT}: gradient gap {gaps[0]:.3e}, forces {gaps[1]:.3e}")
    assert gaps[0] > 10 * REMAT_TOL
    assert torch.equal(f1, f0) == (family == "t")


@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_remat_edge_partition_replay(family):
    """The edge-partitioned Functions (one rank, ``ring_apply``) take the
    same replay: forces bitwise those without remat, L replays."""
    from torchmdnet_tpu_torch.parallel import make_mesh
    from torchmdnet_tpu_torch.parallel.edge_partition import ring_apply

    mesh = make_mesh(allow_single=True, device="cpu")
    batch = _fused_batch()
    out = {}
    for remat in (False, True):
        save_list.reset_replays()
        model = create_model(_args(family, remat), device="cpu", seed=1)
        out[remat] = ring_apply(model, batch, mesh, boundary_capacity=0)
    assert save_list.replays == {KERNEL[family]: LAYERS}
    assert torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1])


def test_jvp_rule_keeps_no_graph_alive():
    """``derivatives.jvp`` inside a checkpointed call (saved-tensor hooks
    active, as a fused Function's jvp rule runs under remat) gives forward
    mode's tangent and releases its own graph: a saved output that stayed
    in a hook would keep its node, and the device memory, alive for good."""
    import gc
    import weakref

    import torch.autograd.forward_ad as fwAD
    from torch.utils.checkpoint import checkpoint

    from torchmdnet_tpu_torch.ops.kernels import derivatives

    refs = []

    def fn(a, b):
        y = torch.sigmoid(a * b)  # saves its output
        refs.append(weakref.ref(y))
        return y.exp(), (a * b).sin()

    g = torch.Generator().manual_seed(0)
    a, b, ta, tb = (torch.randn(64, dtype=torch.float64, generator=g) for _ in range(4))
    w = torch.ones((), dtype=torch.float64, requires_grad=True)
    out = {}
    checkpoint(lambda w: out.setdefault("t", derivatives.jvp(fn, [a * w, b], [ta, tb])), w, use_reentrant=False)
    with fwAD.dual_level():
        want = [fwAD.unpack_dual(o).tangent for o in fn(fwAD.make_dual(a, ta), fwAD.make_dual(b, tb))]
    gc.collect()
    assert refs[0]() is None
    for got, ref in zip(out["t"], want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_checkpoint_input_saver_takes_forward_mode():
    """Torch releases whose checkpoint keeps its inputs through
    ``_NoopSaveInputs`` (an ``autograd.Function`` without a ``jvp``) raise
    under forward mode; ``remat_call`` gives it one: its placeholder output
    an empty tangent, the saved inputs keeping their own for the
    recomputation."""
    import types

    import torch.autograd.forward_ad as fwAD

    from torchmdnet_tpu_torch.models import blocks

    class Saver(torch.autograd.Function):  # the shape of those releases' _NoopSaveInputs
        @staticmethod
        def forward(*args):
            return torch.empty((0,))

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*[x for x in inputs if isinstance(x, torch.Tensor)])

        @staticmethod
        def backward(ctx, *grads):
            raise AssertionError("not differentiated")

    g = torch.Generator().manual_seed(0)
    x, t = (torch.randn(5, dtype=torch.float64, generator=g) for _ in range(2))
    dummy = torch.empty((0,), requires_grad=True)
    with fwAD.dual_level():
        dual = fwAD.make_dual(x, t)
        with pytest.raises(NotImplementedError):
            Saver.apply(dummy, dual)
        blocks._give_input_saver_a_jvp(types.SimpleNamespace(_NoopSaveInputs=Saver))
        out = Saver.apply(dummy, dual)
        saved = out.grad_fn.saved_tensors[1]
        assert torch.equal(fwAD.unpack_dual(saved).tangent, t) and torch.equal(saved, x)
        tangent = fwAD.unpack_dual(out).tangent
        assert tangent is None or tangent.numel() == 0
    jvp = Saver.jvp
    blocks._give_input_saver_a_jvp(types.SimpleNamespace(_NoopSaveInputs=Saver))
    assert Saver.jvp is jvp  # given once
