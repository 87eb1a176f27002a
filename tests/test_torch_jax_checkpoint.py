"""The port against the JAX package where this slice meets it, on the CPU.

- ``force_grad_mode="jvp"``: one optimizer step of the port's ``Trainer``
  against JAX's ``Trainer(force_grad_mode="jvp")._train_step_impl`` on
  tests/test_torch_train.py's batch and weights (ET with an Atomref prior,
  EMA, clipping that triggers, weight decay, warmup): the losses and the
  updated parameters, f64 to 1e-8 and the port's f32 step to 1e-5
  (relative, with an absolute floor of the same size), both against JAX's
  f64 step.
- A third derivative of the fused ET edge phase through the port's
  Functions (the kernels' plain twins) against JAX's ``jax.grad`` three
  times over its composable ``_reference`` (tests/test_et_fused.py) on a
  scalar probe, as tests/test_et_fused.py:187-203 probes the second: f64
  inputs, to 1e-6 (the JAX reference sums in f32).
- Checkpoints written by the JAX package (``TMDNTPU2``, flax msgpack) read
  by the port's own decoder: the decoded trees equal flax's bitwise, the
  state_dict equals ``state_dict_from_jax`` of JAX's params bitwise,
  ``load_model`` and ``External`` serve JAX's energies and forces (f64,
  1e-10), ``--load-model`` takes the hyperparameters from the header, and a
  resume's next step equals JAX's resumed next step (f64, 1e-8).
- The committed JAX checkpoint under tests/data/ (which ``chip_smoke.py``
  serves on the card) is what ``write_jax_checkpoint`` makes from its seed,
  and its reference energies and forces are JAX's.  To write it anew:
  ``python tests/test_torch_jax_checkpoint.py``.
"""

import functools
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests import test_torch_train as tt  # noqa: E402
from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules  # noqa: E402
from torchmdnet_tpu.models.potential import create_model as jax_create_model  # noqa: E402
from torchmdnet_tpu.models.potential import create_prior_models as jax_create_prior_models  # noqa: E402
from torchmdnet_tpu.ops.rbf import ExpNormalSmearing  # noqa: E402
from torchmdnet_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from torchmdnet_tpu.train.trainer import TrainerState as JaxTrainerState  # noqa: E402
from torchmdnet_tpu_torch import state_dict_from_jax  # noqa: E402
from torchmdnet_tpu_torch.models.potential import load_model  # noqa: E402
from torchmdnet_tpu_torch.train import checkpoints  # noqa: E402
from torchmdnet_tpu_torch.train.trainer import Trainer  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")
SERVED = os.path.join(DATA, "jax_et.ckpt")
SERVED_REF = os.path.join(DATA, "jax_et_ref.npz")
# the served checkpoint: a small ET with JAX's own hyperparameter names, f32
SERVED_ARGS = dict(
    model="equivariant-transformer", embedding_dimension=32, num_layers=2, num_rbf=16, rbf_type="expnorm",
    trainable_rbf=False, activation="silu", attn_activation="silu", neighbor_embedding=True, num_heads=4,
    distance_influence="both", cutoff_lower=0.0, cutoff_upper=5.0, max_z=100, max_num_neighbors=32,
    derivative=True, output_model="Scalar", prior_model=None, reduce_op="add", atom_filter=-1, precision=32,
    bf16_messages=False, fused_attention=False, lr=1e-4, seed=7,
)
SERVED_MOLECULES, SERVED_ATOMS = 4, 18
# the trainers' log directory (JAX's writes its configuration there)
_LOGS = tempfile.TemporaryDirectory()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- force_grad_mode="jvp" against JAX's ---------------------------------


@functools.lru_cache(maxsize=None)
def _jax_jvp_step(precision):
    """JAX's jvp-mode trainer and its train step, compiled once (shared by
    the step, read, serve and resume tests)."""
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(tt.ARGS, precision=precision)
    # prior_args as JAX's CLI writes them: a checkpoint's priors replay from them
    priors = tt.create_prior_models(args, tt._dataset())
    h = dict(args, **tt.HPARAMS, force_grad_mode="jvp", log_dir=_LOGS.name,
             prior_args=[p.get_init_args() for p in priors])
    jtr = JaxTrainer(jax_create_model(args, jax_create_prior_models(args, tt._dataset())), h)
    params = tt._jax_params(precision)
    opt_state = jax.jit(jtr.optimizer.init)(params)
    # the first step's warmup learning rate, as the JAX host loop sets it
    opt_state = jtr._set_lr(opt_state, jtr._current_lr(JaxTrainerState(params=None, opt_state=None, lr=h["lr"])))
    call = (params, opt_state, jnp.zeros((4,), fdt), tt._jax_batch(fdt), jnp.asarray(0.0, fdt),
            jnp.asarray(0.0, fdt))
    step = jax.jit(jtr._train_step_impl).lower(*call).compile(compiler_options=tt.FAST_COMPILE)
    return jtr, h, step, call


def _port_trainer(precision, h):
    return Trainer(tt._port_model(dict(tt.ARGS, precision=precision), precision), h)


def _assert_params_equal(ptr, args, params, tol, what):
    want = state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, params))
    got = ptr.model.module.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=tol, atol=tol, err_msg=f"{k} {what}")


@pytest.mark.parametrize("precision,tol", [(64, 1e-8), (32, 1e-5)])
def test_jvp_step_matches_jax(precision, tol):
    """The port's step in ``precision`` against JAX's f64 step, compiled
    once (an f32 JAX step would round as the port's f32 one does, well
    inside 1e-5, and cost a second compile)."""
    jtr, h, step, call = _jax_jvp_step(64)
    params, opt_state, acc, ly, lf = step(*call)
    ptr = _port_trainer(precision, dict(h, precision=precision))
    pacc = torch.zeros(4, dtype=ptr.dtype)
    zero = torch.zeros((), dtype=ptr.dtype)
    fdt = np.float64 if precision == 64 else np.float32
    pema = ptr._train_step(tt._port_batch(fdt), pacc, zero, zero)
    np.testing.assert_allclose([float(v) for v in pema], [float(ly), float(lf)], rtol=tol)
    np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), rtol=tol)
    _assert_params_equal(ptr, dict(tt.ARGS, precision=precision), params, tol, "after a jvp step")
    assert float(acc[1]) > 0 and float(acc[2]) > 0


# --- a third derivative of the fused ET against JAX's ------------------------


def test_et_third_derivative_matches_jax_probe(monkeypatch):
    from tests import test_et_fused as jf
    from tests import test_torch_et_bwd2 as eb
    from tests.test_torch_force_grad_jvp import _phase_inputs
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    # _reference's widths (H 128, 8 heads) on a symmetric list of 24 atoms
    ins, tidx, perm = _phase_inputs("et", seed=5, h=jf.H, rbf=jf.RBF)
    jins = {n: jnp.asarray(v.numpy()) for n, v in ins.items()}
    jidx = jnp.asarray(tidx.numpy())

    def loss_jax(a):
        x, vec = jf._reference(jidx, dict(jins, q=a * jins["q"]))
        return jnp.sum(x ** 2) + 0.1 * jnp.sum(vec ** 3)

    g3 = jax.grad(jax.grad(jax.grad(loss_jax)))
    want = float(jax.jit(g3).lower(1.0).compile(compiler_options=tt.FAST_COMPILE)(1.0))

    monkeypatch.setattr(em, "run_fwd", eb._plain_fwd)
    monkeypatch.setattr(em, "run_bwd", eb._plain_bwd)
    monkeypatch.setattr(em, "run_bwd2", eb._plain_bwd2)
    for fn in (eb._plain_fwd, eb._plain_bwd, eb._plain_bwd2):
        fn.launches = 0
    a = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    args = [a * ins["q"] if n == "q" else ins[n] for n in eb.ORDER]
    x, vec = em._EtMessages.apply((jf.HEADS, "silu", "silu"), tidx, perm, *args)
    loss = (x ** 2).sum() + 0.1 * (vec ** 3).sum()
    (d1,) = torch.autograd.grad(loss, a, create_graph=True)
    (d2,) = torch.autograd.grad(d1, a, create_graph=True)
    (d3,) = torch.autograd.grad(d2, a)
    assert eb._plain_bwd2.launches >= 1  # the second order ran its (plain) kernel
    print(f"d3 loss / da3: port {float(d3):.9e}, JAX {want:.9e}")
    np.testing.assert_allclose(float(d3), want, rtol=1e-6)


# --- checkpoints written by the JAX package ----------------------------------


def _served_batch():
    """The served checkpoint's molecules: SyntheticMorse-like frames of 18
    atoms, seeded."""
    rng = np.random.default_rng(3)
    mols = [{"z": rng.integers(1, 10, SERVED_ATOMS).astype(np.int32),
             "pos": (rng.uniform(0, 4.0, (SERVED_ATOMS, 3))).astype(np.float32)} for _ in range(SERVED_MOLECULES)]
    return mols


def _served_params(jm, jb):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    a = SERVED_ARGS
    rbf = ExpNormalSmearing(a["cutoff_lower"], a["cutoff_upper"], a["num_rbf"], buffer_dtype=np.float32)
    means, betas = (np.asarray(x) for x in rbf._initial_params())
    rng = np.random.default_rng(a["seed"])

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):
            return means if name == "means" else betas
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        return (rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def write_jax_checkpoint(path, ref_path):
    """The served checkpoint, written by the JAX package's ``save_checkpoint``
    (params only), and JAX's energies and forces on its molecules."""
    from torchmdnet_tpu.train.checkpoints import save_checkpoint

    mols = _served_batch()
    n = SERVED_MOLECULES * SERVED_ATOMS
    jb = jax_pad_molecules(mols, num_atoms=n, num_mol=SERVED_MOLECULES)
    jm = jax_create_model(SERVED_ARGS)
    params = _served_params(jm, jb)
    save_checkpoint(path, params, SERVED_ARGS, extra={"epoch": 1, "global_step": 0})
    y, f = jax.jit(jm.energy_and_forces).lower(params, jb).compile(compiler_options=tt.FAST_COMPILE)(params, jb)
    np.savez(ref_path, z=np.concatenate([m["z"] for m in mols]), pos=np.concatenate([m["pos"] for m in mols]),
             energy=np.asarray(y).reshape(-1), forces=np.asarray(f))


def test_committed_jax_checkpoint_is_reproduced(tmp_path):
    path, ref = tmp_path / "served.ckpt", tmp_path / "served_ref.npz"
    write_jax_checkpoint(str(path), str(ref))
    committed = checkpoints.load_checkpoint(SERVED)
    fresh = checkpoints.load_checkpoint(str(path))
    assert committed["hyper_parameters"] == fresh["hyper_parameters"] == SERVED_ARGS
    assert committed["state_dict"].keys() == fresh["state_dict"].keys()
    for k, v in fresh["state_dict"].items():
        assert torch.equal(committed["state_dict"][k], v), k
    assert os.path.getsize(SERVED) < 300_000
    a, b = np.load(SERVED_REF), np.load(ref)
    for key in ("z", "pos"):
        np.testing.assert_array_equal(a[key], b[key])
    for key in ("energy", "forces"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5 * np.abs(b[key]).max())


def _jax_checkpoint(tmp_path, precision):
    """A JAX trainer's checkpoint after one jvp-mode step (its optax state
    live), and what JAX computes from it: (path, the step's losses, the
    trainer, the compiled step and its call)."""
    jtr, h, step, call = _jax_jvp_step(precision)
    params, opt_state, _, ly, lf = step(*call)
    state = JaxTrainerState(params=params, opt_state=opt_state, epoch=0, global_step=1, lr=h["lr"],
                            ema={"train_y": float(ly), "train_neg_dy": float(lf)})
    path = str(tmp_path / "jax.ckpt")
    jtr.save_checkpoint(path, state)
    return path, jtr, step, call


def test_jax_checkpoint_reads_without_flax(tmp_path):
    from flax import serialization

    from torchmdnet_tpu.train.checkpoints import load_checkpoint as jax_load

    path, _, _, _ = _jax_checkpoint(tmp_path, 64)
    assert checkpoints.is_jax_checkpoint(path)
    ck, jck = checkpoints.load_checkpoint(path), jax_load(path)
    assert ck["hyper_parameters"] == jck["hyper_parameters"] and ck["extra"] == jck["extra"]
    flat = jax.tree_util.tree_leaves_with_path
    for mine, theirs in ((ck["jax_params"], jck["params"]),
                         (ck["jax_opt_state"], serialization.msgpack_restore(jck["blobs"]["opt_state"]))):
        a, b = flat(mine), flat(theirs)
        assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 10
        for (_, x), (_, y) in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(np.asarray(x), np.asarray(y))
    want = state_dict_from_jax(jck["hyper_parameters"], jck["params"])
    assert ck["state_dict"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(ck["state_dict"][k], v), k
    assert checkpoints.read_hyperparameters(path) == jck["hyper_parameters"]
    # the CLI's --load-model takes the header's hyperparameters when no
    # hparams.yaml lies beside the checkpoint
    from torchmdnet_tpu_torch.scripts.train import get_args

    with pytest.warns(UserWarning, match="hparams.yaml"):
        ns = get_args(["--load-model", path])
    assert ns.force_grad_mode == "jvp" and ns.embedding_dimension == tt.ARGS["embedding_dimension"]


def test_jax_checkpoint_serves_jax_energies(tmp_path):
    from torchmdnet_tpu_torch.calculators import External

    path, _, _, _ = _jax_checkpoint(tmp_path, 64)
    jck = checkpoints.load_checkpoint(path)
    args = jck["hyper_parameters"]
    mols = tt._mols(np.float64)
    jb = tt._jax_batch(np.float64)
    jm = jax_create_model(args, jax_create_prior_models(args, tt._dataset()))
    params = jck["jax_params"]
    y, f = jax.jit(jm.energy_and_forces).lower(params, jb).compile(compiler_options=tt.FAST_COMPILE)(params, jb)
    model = load_model(path, device="cpu")
    py, pf = model.energy_and_forces(tt._port_batch(np.float64))
    np.testing.assert_allclose(py.numpy(), np.asarray(y), rtol=1e-10)
    np.testing.assert_allclose(pf.numpy(), np.asarray(f), rtol=1e-10, atol=1e-10 * np.abs(np.asarray(f)).max())
    # External serves the same three molecules of 8 atoms
    z = np.stack([m["z"] for m in mols])
    ext = External((model, None), z, device="cpu")
    ey, ef = ext.calculate(torch.as_tensor(np.stack([m["pos"] for m in mols])))
    n = tt.N_ATOMS
    np.testing.assert_allclose(ey.numpy().reshape(-1), np.asarray(y).reshape(-1), rtol=1e-10)
    np.testing.assert_allclose(ef.numpy().reshape(n, 3), np.asarray(f)[:n], rtol=1e-9,
                               atol=1e-10 * np.abs(np.asarray(f)).max())


def test_jax_checkpoint_resumes_to_jax_next_step(tmp_path):
    path, jtr, step, call = _jax_checkpoint(tmp_path, 64)
    # JAX: its own restore, then the next step at the restored lr and EMA
    template = JaxTrainerState(params=call[0], opt_state=call[1])
    state = jtr._restore(path, template)
    lr = jtr._current_lr(state)
    opt_state = jtr._set_lr(state.opt_state, lr)
    ema = (jnp.asarray(state.ema["train_y"], jnp.float64), jnp.asarray(state.ema["train_neg_dy"], jnp.float64))
    params, _, acc, ly, lf = step(state.params, opt_state, call[2], call[3], *ema)
    # the port: a fresh model (other weights) resumed from the JAX file
    h = dict(jtr.h)
    ptr = Trainer(tt._port_model(dict(tt.ARGS, precision=64), 64), h)
    for p in ptr.params:
        p.data.normal_()
    ptr._restore(path)
    assert (ptr.state.epoch, ptr.state.global_step) == (1, 1)
    assert ptr._current_lr(ptr.state) == lr
    ema_p = [torch.tensor(ptr.state.ema[k], dtype=torch.float64) for k in ("train_y", "train_neg_dy")]
    pacc = torch.zeros(4, dtype=torch.float64)
    pema = ptr._train_step(tt._port_batch(np.float64), pacc, *ema_p)
    np.testing.assert_allclose([float(v) for v in pema], [float(ly), float(lf)], rtol=1e-8)
    np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), rtol=1e-8)
    _assert_params_equal(ptr, dict(tt.ARGS, precision=64), params, 1e-8, "after the resumed step")
    # the optimizer's moments came from the checkpoint (a fresh AdamW's
    # first step would differ)
    assert all(float(s["step"]) == 2 for s in ptr.optimizer.state.values())


if __name__ == "__main__":
    os.makedirs(DATA, exist_ok=True)
    write_jax_checkpoint(SERVED, SERVED_REF)
    print(f"wrote {SERVED} ({os.path.getsize(SERVED)} bytes) and {SERVED_REF}")
