"""The plain reference ET against the port's composable ET (float32, the
same weights): energies, forces and a force-loss gradient, at a small size
on the CPU.  This test imports both; the reference itself imports nothing
of the port."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from nnpbench.tests import tiny
from nnpbench.inputs.systems import lattice_system, synthetic_system
from nnpbench.reference import et as ref
from nnpbench.reference import weights

ARGS = dict(model="equivariant-transformer", embedding_dimension=32, num_layers=2, num_rbf=16,
            rbf_type="expnorm", trainable_rbf=True, activation="silu", attn_activation="silu",
            neighbor_embedding=True, num_heads=4, distance_influence="both", cutoff_lower=0.0,
            cutoff_upper=5.0, max_z=100, max_num_neighbors=64, derivative=True, output_model="Scalar",
            prior_model=None, reduce_op="add", precision=32, atom_filter=-1)


def _pair(args, seed=3):
    from torchmdnet_tpu_torch import create_model

    r = weights.fill(ref.build(args, "cpu"), seed)
    m = create_model(args, device="cpu")
    m.module.load_state_dict(r.state_dict())
    return r, m


@pytest.mark.parametrize("trainable_rbf,side", [(True, None), (False, None), (True, 11.0)])
def test_reference_matches_composable_port(trainable_rbf, side):
    """In open space and in a periodic cube (minimum image; positions
    outside the cube too, as MD leaves them)."""
    from torchmdnet_tpu_torch.data.batch import pad_molecules

    args = dict(ARGS, trainable_rbf=trainable_rbf)
    r, m = _pair(args)
    if side is None:
        z, pos = synthetic_system(60, 1)
        box = None
    else:
        z, pos, side = lattice_system(60, 0.2, 1, density=60 / side ** 3)
        pos[:7] += side  # images, not the cube's own positions
        box = torch.eye(3) * side
    y, f = m.energy_and_forces(pad_molecules([{"z": z, "pos": pos}], num_atoms=64), box=box)
    zt, pt = torch.as_tensor(z).long(), torch.as_tensor(pos)
    yr, fr, _ = r.energy_and_forces(zt, pt, r.graph(pt, torch.zeros(60, dtype=torch.long), 1, side))
    assert torch.allclose(y.flatten(), yr, rtol=1e-5, atol=1e-6)
    assert (f[:60] - fr).abs().max() <= 1e-5 * fr.abs().max()


def test_reference_force_loss_gradient_matches_port():
    """Two molecules, the energy and force loss, gradients to every weight."""
    from torchmdnet_tpu_torch.data.batch import pad_molecules

    r, m = _pair(ARGS)
    mols = [synthetic_system(n, s) for n, s in ((20, 4), (30, 5))]
    batch = pad_molecules([{"z": z, "pos": p} for z, p in mols], num_atoms=56)
    y, f = m.energy_and_forces(batch, create_graph=True)
    loss = (y ** 2).sum() + (f ** 2).sum()
    names = [n for n, _ in m.module.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.module.parameters()))
    z = torch.as_tensor(np.concatenate([z for z, _ in mols])).long()
    pos = torch.as_tensor(np.concatenate([p for _, p in mols]))
    mol = torch.as_tensor([0] * 20 + [1] * 30)
    yr, fr, _ = r.energy_and_forces(z, pos, r.graph(pos, mol, 2), create_graph=True)
    lr = (yr ** 2).sum() + (fr ** 2).sum()
    params = dict(r.named_parameters())
    gr = torch.autograd.grad(lr, [params[n] for n in names])
    for n, a, b in zip(names, grads, gr):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()) + 1e-9), n


def test_fused_bf16_within_the_bf16_band():
    """The port's fused path (its plain bf16 twin on the CPU) sits as far
    from the reference as the reference rounded to bf16 does, and well
    inside what the float8 control reads."""
    from torchmdnet_tpu_torch import create_model
    from torchmdnet_tpu_torch.data.batch import pad_molecules

    args = dict(ARGS, bf16_messages=True, fused_attention=True)
    r = weights.fill(ref.build(ARGS, "cpu"), 5)
    m = create_model(args, device="cpu")
    m.module.load_state_dict(r.state_dict())
    z, pos = synthetic_system(60, 1)
    _, f = m.energy_and_forces(pad_molecules([{"z": z, "pos": pos}], num_atoms=64))
    zt, pt = torch.as_tensor(z).long(), torch.as_tensor(pos)
    g = r.graph(pt, torch.zeros(60, dtype=torch.long), 1)
    _, fr, _ = r.energy_and_forces(zt, pt, g)
    r.set_message_rounding(torch.float8_e4m3fn)
    _, f8, _ = r.energy_and_forces(zt, pt, g)
    rms = fr.norm(dim=1).pow(2).mean().sqrt()
    fused = float((f[:60] - fr).norm(dim=1).max() / rms)
    control = float((f8 - fr).norm(dim=1).max() / rms)
    assert fused < 0.05 and control > 3 * fused


def test_tf32_rounding():
    """TF32 keeps 10 bits of mantissa, to nearest: bfloat16 values pass
    unchanged, float32's last 13 bits go, the error is within half a TF32
    unit."""
    x = torch.randn(4096) * 10.0
    t = ref.round_tf32(x)
    assert torch.equal(ref.round_tf32(x.bfloat16().float()), x.bfloat16().float())
    assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("node", ["tf32", torch.bfloat16])
def test_node_rounding_moves_the_forces_a_little(node):
    """The float32 parts' products in a lower precision: forces within that
    precision's reach of float32's, not equal to them."""
    args = dict(ARGS, max_num_neighbors=80)
    r = weights.fill(ref.build(args, "cpu"), 7)
    z, pos = synthetic_system(60, 2)
    zt, pt = torch.as_tensor(z).long(), torch.as_tensor(pos)
    f = ref.system_forces(r, zt, pt)
    r.set_node_rounding(node)
    g = ref.system_forces(r, zt, pt)
    rel = float((g - f).norm(dim=1).pow(2).mean().sqrt() / f.norm(dim=1).pow(2).mean().sqrt())
    assert 0 < rel < (0.01 if node == "tf32" else 0.1)


def test_lattice_keeps_its_distances_and_density():
    z, pos, side = lattice_system(1000, 0.2, 11)
    assert abs(1000 / side ** 3 - 0.094) < 1e-9 and pos.min() >= 0 and pos.max() < side
    d = torch.as_tensor(pos)[None] - torch.as_tensor(pos)[:, None]
    d = d - side * torch.round(d / side)
    r = d.norm(dim=-1) + 1e9 * torch.eye(1000)
    assert float(r.min()) >= (1 - 2 * 0.2) * side / 10 - 1e-4
    assert sorted(set(z.tolist())) <= [1, 6, 7, 8, 16]


def test_reference_imports_nothing_of_the_program():
    here = os.path.join(tiny.ROOT, "nnpbench", "reference")
    for path in glob.glob(os.path.join(here, "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("torchmdnet_tpu_torch", "torchmdnet_tpu", "jax", "flax"), (path, name)
