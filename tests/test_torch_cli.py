"""The port's training CLI on the CPU: ``scripts.train.main`` on a tiny
DummyDataset configuration with ``--device cpu`` writes its metrics, top-k
checkpoints and resolved configuration, ``--load-model`` resumes at the next
epoch, ``--conf`` merges a YAML file, and the flag set (with defaults) is
the JAX parser's plus the port's own ``--device``.
"""

import argparse
import json
import os

import pytest
import torch
import yaml

from torchmdnet_tpu.scripts import train as jax_cli
from torchmdnet_tpu_torch.scripts import train as cli
from torchmdnet_tpu_torch.train.checkpoints import latest_checkpoint

TINY = [
    "--device", "cpu", "--model", "equivariant-transformer", "--embedding-dimension", "32",
    "--num-layers", "1", "--num-rbf", "8", "--num-heads", "4", "--max-num-neighbors", "16",
    "--cutoff-upper", "3.0", "--derivative", "true", "--batch-size", "4", "--train-size", "8",
    "--val-size", "4", "--test-size", "4", "--dataset", "DummyDataset", "--save-interval", "1",
    "--num-workers", "0", "--lr", "1e-3", "--bf16-messages", "true", "--fused-attention", "true",
    "--prior-model", "Atomref",
]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _run(tmp_path, *extra):
    return cli.main(TINY + ["--log-dir", str(tmp_path / "logs"), "--dataset-root", str(tmp_path)]
                    + list(extra))


def test_train_writes_outputs_and_resumes(tmp_path):
    trainer, test_metrics = _run(tmp_path, "--num-epochs", "2")
    logs = tmp_path / "logs"
    names = sorted(os.listdir(logs))
    ckpts = [n for n in names if n.endswith(".ckpt")]
    assert [n.split("-")[0] for n in ckpts] == ["epoch=0", "epoch=1"]
    assert {"metrics.csv", "input.yaml", "hparams.yaml", "splits.npz"} <= set(names)
    with open(logs / "input.yaml") as f:
        resolved = yaml.safe_load(f)  # JSON, which YAML readers take
    assert resolved["embedding_dimension"] == 32 and "conf" not in resolved
    assert trainer.state.global_step == 4 and all(v == v for v in test_metrics.values())
    assert os.path.basename(latest_checkpoint(str(logs))) == ckpts[-1]
    # --load-model restores the hyperparameters and the trainer state, and
    # later flags override them
    trainer2, _ = cli.main(["--load-model", str(logs / ckpts[-1]), "--num-epochs", "3"])
    assert trainer2.state.epoch == 2 and trainer2.state.global_step == 6
    with open(logs / "metrics.csv") as f:
        rows = f.read().splitlines()
    assert rows[1].startswith("2.0,")  # the resumed run logs epoch 2 only


def test_conf_yaml_merges_and_rejects_unknown_keys(tmp_path):
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.safe_dump({"num_layers": 2, "num_rbf": 16}))
    args = cli.get_args(["--conf", str(conf), "--num-rbf", "8", "--log-dir", str(tmp_path)])
    assert args.num_layers == 2 and args.num_rbf == 8
    conf.write_text(yaml.safe_dump({"no_such_flag": 1}))
    with pytest.raises(ValueError, match="Unknown argument"):
        cli.get_args(["--conf", str(conf), "--log-dir", str(tmp_path)])


def test_train_on_custom_npy_files(tmp_path, monkeypatch):
    """--dataset Custom reads the globs of --coord-files etc. through
    DataModule's Custom branch: two steps, finite losses."""
    import csv
    import math

    import numpy as np

    from torchmdnet_tpu_torch.data.datasets import Custom
    from torchmdnet_tpu_torch.data.module import DataModule

    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 7)):
        np.save(tmp_path / f"coords_{i}.npy", rng.normal(size=(8, n, 3)).astype(np.float32) * 1.5)
        np.save(tmp_path / f"embed_{i}.npy", rng.integers(1, 9, n))
        np.save(tmp_path / f"energy_{i}.npy", rng.normal(size=(8, 1)))
        np.save(tmp_path / f"force_{i}.npy", rng.normal(size=(8, n, 3)).astype(np.float32))
    seen = []
    setup = DataModule.setup

    def recording_setup(self):
        setup(self)
        seen.append(self.dataset)

    monkeypatch.setattr(DataModule, "setup", recording_setup)
    flags = TINY[:TINY.index("--dataset")] + [
        "--dataset", "Custom", "--coord-files", str(tmp_path / "coords_*.npy"),
        "--embed-files", str(tmp_path / "embed_*.npy"), "--energy-files", str(tmp_path / "energy_*.npy"),
        "--force-files", str(tmp_path / "force_*.npy"), "--num-workers", "0", "--lr", "1e-3",
        "--bf16-messages", "true", "--fused-attention", "true", "--num-epochs", "1",
        "--log-dir", str(tmp_path / "logs"), "--dataset-root", str(tmp_path / "unused"),
    ]
    trainer, test_metrics = cli.main(flags)
    assert len(seen) == 1 and isinstance(seen[0], Custom) and len(seen[0]) == 16
    assert trainer.state.global_step == 2  # 8 training molecules, batches of 4
    with open(tmp_path / "logs" / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train_total_mse_loss")]
    losses = [float(r["train_total_mse_loss"]) for r in rows] + [float(v) for v in test_metrics.values()]
    assert rows and all(math.isfinite(v) for v in losses)


def test_standardized_checkpoint_reloads_its_mean_and_std(tmp_path):
    """--standardize scales the model by the training energies' std and
    shifts it by their mean; the checkpoint keeps both, so load_model
    serves the trained model's energies and forces."""
    from torchmdnet_tpu_torch.data.datasets import DummyDataset
    from torchmdnet_tpu_torch.data.batch import pad_molecules
    from torchmdnet_tpu_torch.models.potential import load_model

    trainer, _ = _run(tmp_path, "--num-epochs", "1", "--standardize", "true")
    module = trainer.model.module
    assert module.std != 1.0 and module.mean != 0.0
    reloaded = load_model(trainer.best_model_path, device="cpu")
    assert (reloaded.module.mean, reloaded.module.std) == (module.mean, module.std)
    ds = DummyDataset(num_samples=2, num_atoms=5, seed=3)
    batch = pad_molecules([ds[0], ds[1]], num_atoms=16, num_mol=2)
    e, f = trainer.model.energy_and_forces(batch)
    e2, f2 = reloaded.energy_and_forces(batch)
    assert torch.equal(e, e2) and torch.equal(f, f2)


def _parser(module, monkeypatch):
    """The ArgumentParser the module's get_args builds (stopped at parsing)."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        module.get_args([])
    monkeypatch.undo()
    return {a.option_strings[0]: a.default for a in seen["parser"]._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_flags_equal_jax(monkeypatch):
    port, ref = _parser(cli, monkeypatch), _parser(jax_cli, monkeypatch)
    assert set(cli.PORT_ONLY_FLAGS) == {"--device"}
    assert set(port) - set(cli.PORT_ONLY_FLAGS) == set(ref)
    assert {k: v for k, v in port.items() if k not in cli.PORT_ONLY_FLAGS} == ref
    assert json.dumps(cli.HEAD_CHOICES)  # the JAX package's head names
