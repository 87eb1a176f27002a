"""The port's reference-checkpoint import held against the JAX package's, on
the CPU.

For ET (distance influence keys, values and both), the Transformer, the
graph network and TensorNet at tiny widths, with an Atomref prior: a
reference-keyed state dict of random numpy tensors (the reference's key
names and (out, in) shapes, its ``model.`` prefix and its buffers) goes
through the port's ``import_state_dict`` and through JAX's
``import_state_dict`` followed by ``state_dict_from_jax``; the two must be
equal key for key, dtype for dtype and bitwise.  Then the same tensors,
``torch.save``d in a Lightning checkpoint's layout, come back through
``import_checkpoint`` and serve the energy and forces of ``create_model``
with that state dict, bitwise.  No JAX program is compiled.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu.tools.import_torch import import_state_dict as jax_import_state_dict
from torchmdnet_tpu_torch import create_model
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.tools.from_jax import state_dict_from_jax
from torchmdnet_tpu_torch.tools.import_torch import import_checkpoint, import_state_dict, load_torch_checkpoint

BASE = dict(
    embedding_dimension=32, num_layers=2, num_rbf=8, rbf_type="expnorm", trainable_rbf=False,
    activation="silu", attn_activation="silu", neighbor_embedding=True, num_heads=4,
    distance_influence="both", cutoff_lower=0.0, cutoff_upper=4.0, max_z=10, max_num_neighbors=16,
    derivative=True, output_model="Scalar", reduce_op="add", precision=32, atom_filter=-1,
    prior_model="Atomref", prior_args=[{"max_z": 10}], aggr="add", equivariance_invariance_group="O(3)",
)
CASES = {
    "et-both": dict(model="equivariant-transformer"),
    "et-keys": dict(model="equivariant-transformer", distance_influence="keys", trainable_rbf=True),
    "et-values": dict(model="equivariant-transformer", distance_influence="values"),
    "transformer": dict(model="transformer", trainable_rbf=True),
    "graph-network": dict(model="graph-network", rbf_type="gauss", trainable_rbf=True),
    "tensornet": dict(model="tensornet", neighbor_embedding=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_state_dict(args, seed):
    """Random tensors under the reference's keys: the port's own names and
    shapes (it keeps the reference's), its prior as ``prior_model.{i}``, the
    ``model.`` prefix, and the buffers the reference saves besides (mean,
    std, Atomref's initial table; a fixed RBF's constants are buffers in
    both)."""
    rng = np.random.default_rng(seed)
    template = create_model(args, device="cpu").module.state_dict()
    sd = {}
    for key, value in template.items():
        if key.startswith("priors."):
            i = key.split(".")[1]
            key = f"prior_model.{i}.atomref.weight"
            sd[f"model.prior_model.{i}.initial_atomref"] = rng.normal(size=value.shape).astype(np.float32)
        sd["model." + key] = rng.normal(scale=0.3, size=tuple(value.shape)).astype(np.float32)
    sd["model.mean"] = np.asarray(0.25, np.float32)
    sd["model.std"] = np.asarray(1.5, np.float32)
    return sd


def _args(case):
    return dict(BASE, **CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_state_dict_equals_jax_then_from_jax(case):
    args = _args(case)
    ref = _reference_state_dict(args, seed=len(case))
    got = import_state_dict(args, ref)
    want = state_dict_from_jax(args, jax_import_state_dict(args, ref))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert torch.equal(got[key], value), key
    # torch tensors and keys without the prefix import the same
    bare = {k[len("model."):]: torch.as_tensor(v) for k, v in ref.items()}
    again = import_state_dict(args, bare)
    assert all(torch.equal(again[k], v) for k, v in got.items()) and sorted(again) == sorted(got)


def test_import_permutes_et_value_rows_per_head():
    """ET's v_proj rows: the reference's per-head (head, part, dim) order
    becomes the port's global thirds (part, head, dim); the others stay."""
    args = _args("et-both")
    ref = _reference_state_dict(args, seed=3)
    got = import_state_dict(args, ref)
    h, heads = args["embedding_dimension"], args["num_heads"]
    hd = h // heads
    w = ref["model.representation_model.attention_layers.0.v_proj.weight"]
    out = got["representation_model.attention_layers.0.v_proj.weight"].numpy()
    for part in range(3):
        for g in range(heads):
            np.testing.assert_array_equal(out[part * h + g * hd:part * h + (g + 1) * hd],
                                          w[g * 3 * hd + part * hd:g * 3 * hd + (part + 1) * hd])
    np.testing.assert_array_equal(got["representation_model.attention_layers.0.q_proj.weight"].numpy(),
                                  ref["model.representation_model.attention_layers.0.q_proj.weight"])


def _batch():
    rng = np.random.default_rng(7)
    mols = [dict(z=rng.integers(1, 10, n).astype(np.int64),
                 pos=(rng.normal(size=(n, 3)) * 1.2).astype(np.float32)) for n in (5, 7)]
    return pad_molecules(mols, num_atoms=16, num_mol=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_checkpoint_serves_create_model(case, tmp_path):
    args = _args(case)
    ref = _reference_state_dict(args, seed=11 + len(case))
    path = tmp_path / "reference.ckpt"
    torch.save({"hyper_parameters": dict(args, load_model=None),
                "state_dict": {k: torch.as_tensor(v) for k, v in ref.items()}}, path)
    model = import_checkpoint(str(path), device="cpu")
    want = create_model(args, mean=0.25, std=1.5, device="cpu")
    from_jax = state_dict_from_jax(args, jax_import_state_dict(args, ref))
    want.module.load_state_dict({**want.module.state_dict(), **from_jax})
    batch = _batch()
    e, f = model.energy_and_forces(batch)
    e_want, f_want = want.energy_and_forces(batch)
    assert torch.isfinite(e).all() and torch.isfinite(f).all()
    assert torch.equal(e, e_want) and torch.equal(f, f_want)
    assert model.device == torch.device("cpu") and model.module.std == 1.5 and model.module.mean == 0.25
    loaded_args, sd = load_torch_checkpoint(str(path))
    assert loaded_args["model"] == args["model"] and sorted(sd) == sorted(import_state_dict(args, ref))
    # keyword overrides reach the model
    assert import_checkpoint(str(path), device="cpu", max_num_neighbors=24).args["max_num_neighbors"] == 24


def test_import_checkpoint_refuses_a_mismatched_model(tmp_path):
    args = _args("et-both")
    ref = _reference_state_dict(args, seed=5)
    path = tmp_path / "reference.ckpt"
    torch.save({"hyper_parameters": args, "state_dict": {k: torch.as_tensor(v) for k, v in ref.items()}}, path)
    with pytest.raises(KeyError, match="attention_layers.2"):
        import_checkpoint(str(path), device="cpu", num_layers=3)
    if not torch.cuda.is_available():
        # no device named: cuda, which is absent here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            import_checkpoint(str(path))
