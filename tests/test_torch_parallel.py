"""Data parallelism of the port (``torchmdnet_tpu_torch.parallel``), on the CPU.

- the loader's rank shards against the JAX package's
  ``PaddedLoader(process_rank, process_count)``: the same molecules, global
  molecule ids and capacities, bitwise (a short last batch leaves one rank's
  shard empty);
- the training CLI with ``--ndevices 2`` (two gloo ranks, started as the
  CLI's launcher starts them) against one process on the same global batches: a 1-layer ET with a
  force loss, one epoch of two steps (batches of 4, then a short one that
  leaves rank 1 no molecule).  The first step's summed gradients agree
  within 1e-5 of each tensor's largest value, and the epoch's loss (the
  mean of the two steps), the validation and test metrics within rtol 1e-5
  (they differ only in the order of float sums);
- the environment rendezvous of ``--num-nodes`` (``initialize_distributed``'s
  ranks, backend and coordinator, without starting a group), ``make_mesh``,
  ``localize_shard``, ``DataModule``'s capacity multiple, the shards' spatial
  sort on the global batch's grid and the CLI's launcher (one rank a device).
"""

import csv
import os
import warnings

import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.data.loader import PaddedLoader
from torchmdnet_tpu_torch.parallel import distributed
from torchmdnet_tpu_torch.parallel.distributed import localize_shard
from torchmdnet_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Molecules:
    """Molecules of 3-9 atoms with energies, forces and partial charges."""

    def __init__(self, n=10, seed=0):
        rng = np.random.default_rng(seed)
        self.sizes = rng.integers(3, 10, n)
        self.items = [dict(z=rng.integers(1, 10, s), pos=rng.normal(size=(s, 3)).astype(np.float32),
                           y=np.float32(rng.normal()), neg_dy=rng.normal(size=(s, 3)).astype(np.float32),
                           pq=rng.normal(size=s).astype(np.float32)) for s in self.sizes]

    def __len__(self):
        return len(self.items)

    def sample_sizes(self):
        return self.sizes

    def __getitem__(self, i):
        return dict(self.items[i])


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_shards_match_jax(rank):
    ds = _Molecules()
    kw = dict(batch_size=4, shuffle=True, seed=3, extra_atom_keys=("partial_charges",), process_rank=rank,
              process_count=2)
    port, ref = PaddedLoader(ds, **kw), JaxPaddedLoader(ds, use_native=False, **kw)
    assert port.num_atoms_pad == ref.num_atoms_pad and port.num_atoms_pad % 16 == 0
    for epoch in range(2):  # the shuffle of each epoch
        pb, jb = list(port), list(ref)
        assert len(pb) == len(jb) == 3
        for p, j in zip(pb, jb):
            assert p.num_mol == j.num_mol == 4 and p.num_atoms == j.num_atoms == port.num_atoms_pad // 2
            for name in ("z", "pos", "batch", "atom_mask", "mol_mask", "y", "neg_dy"):
                a, b = getattr(p, name), getattr(j, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype), err_msg=name)
            np.testing.assert_array_equal(p.extra["partial_charges"].numpy(), np.asarray(j.extra["partial_charges"]))
        # the last global batch has 2 molecules: rank 1's shard is empty
        assert int(pb[-1].mol_mask.sum()) == (2 if rank == 0 else 0)


def test_localize_shard_renumbers_global_ids():
    mols = [dict(z=np.array([1, 6]), pos=np.zeros((2, 3), np.float32)), dict(z=np.array([8]), pos=np.ones((1, 3), np.float32))]
    shard = pad_molecules(mols, num_atoms=4, num_mol=2, mol_id_offset=2, num_mol_global=4)
    assert shard.num_mol == 4 and shard.batch.tolist() == [2, 2, 3, 4]
    local = localize_shard(shard, 1)
    assert local.num_mol == 2 and local.batch.tolist() == [0, 0, 1, 2]
    single = pad_molecules(mols, num_atoms=4, num_mol=2)
    assert localize_shard(single, 0) is single
    with pytest.raises(ValueError, match="num_mol_global"):
        pad_molecules(mols, num_atoms=4, num_mol=2, mol_id_offset=2)


def test_initialize_distributed_env_rendezvous(monkeypatch):
    import torch.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: seen.update(backend=backend, **kw))
    for var in ("MASTER_ADDR", "MASTER_PORT", "NODE_RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed(1) == (0, 1) and not seen  # one process: no group
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize_distributed(2)
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29123")
    monkeypatch.setenv("NODE_RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.initialize_distributed(2, device="cpu") == (3, 4)
    assert seen == dict(backend="gloo", init_method="tcp://node0:29123", world_size=4, rank=3)
    assert distributed.initialize_distributed(2, device="cpu", backend="nccl") == (3, 4)
    assert seen["backend"] == "nccl"  # named by the caller (nodes that share one card name gloo)
    # ranks that share one card cannot use NCCL
    assert distributed.choose_backend(None, 2) == ("gloo" if torch.cuda.device_count() < 2 else "nccl")


def test_make_mesh_layout():
    assert make_mesh() is None  # one process: no mesh
    mesh = make_mesh(allow_single=True, device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend, mesh.shape) == (1, 0, "none", {"dp": 1})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert make_mesh(4, allow_single=True, device="cpu").size == 1
    assert any("Requested 4 devices" in str(w.message) for w in caught)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(allow_single=True)


def test_datamodule_capacity_divides_over_ranks(tmp_path, monkeypatch):
    from torchmdnet_tpu_torch.data.module import DataModule, pad_multiple

    assert (pad_multiple(1), pad_multiple(2), pad_multiple(3), pad_multiple(16)) == (8, 8, 24, 16)
    monkeypatch.setattr(distributed, "process_info", lambda: (1, 3))
    h = dict(batch_size=6, inference_batch_size=6, train_size=12, val_size=6, test_size=6, seed=1,
             log_dir=str(tmp_path), device="cpu", num_workers=0)
    data = DataModule(h, dataset=_Molecules(24))
    data.setup()
    assert data.num_atoms_pad % 24 == 0
    batch = next(iter(data.train_dataloader()))
    assert batch.num_atoms == data.num_atoms_pad // 3 and batch.mol_mask.shape == (2,) and batch.num_mol == 6
    assert set(batch.batch[batch.atom_mask].tolist()) <= {2, 3}  # rank 1's global molecule ids


def test_shard_sorts_as_the_global_batch():
    """A rank's shard sorted on the global batch's grid orders each molecule's
    atoms as the global batch does (bitwise the same rows)."""
    from torchmdnet_tpu_torch.data.batch import spatial_sort

    rng = np.random.default_rng(5)
    mols = [dict(z=rng.integers(1, 10, s), pos=(rng.normal(size=(s, 3)) * 3 + rng.normal(size=3) * 4).astype(np.float32))
            for s in rng.integers(5, 12, 8)]
    whole, _ = spatial_sort(pad_molecules(mols, num_atoms=96, num_mol=8), cell=2.0)
    shards = [pad_molecules(mols[4 * r:4 * r + 4], num_atoms=48, num_mol=4, mol_id_offset=4 * r, num_mol_global=8)
              for r in range(2)]
    origin = torch.stack([s.pos.amin(dim=0) for s in shards]).amin(dim=0)
    for r, shard in enumerate(shards):
        mine, _ = spatial_sort(localize_shard(shard, r), cell=2.0, origin=origin)
        rows = (whole.batch >= 4 * r) & (whole.batch < 4 * r + 4) & whole.atom_mask
        n = int(rows.sum())
        assert torch.equal(mine.z[:n], whole.z[rows]) and torch.equal(mine.pos[:n], whole.pos[rows])


TINY = ["--device", "cpu", "--model", "equivariant-transformer", "--embedding-dimension", "32",
        "--num-layers", "1", "--num-rbf", "8", "--num-heads", "4", "--max-num-neighbors", "16",
        "--cutoff-upper", "3.0", "--derivative", "true", "--batch-size", "4", "--train-size", "6",
        "--val-size", "4", "--test-size", "4", "--dataset", "DummyDataset", "--save-interval", "1",
        "--num-workers", "0", "--lr", "1e-3", "--num-epochs", "1", "--neg-dy-weight", "0.5"]


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        return [{k: float(v) for k, v in row.items() if v not in ("", None)} for row in csv.DictReader(f)]


# one rank of the CLI whose trainer saves the first step's gradients (its
# ``on_before_optimizer_step`` hook): python -c _RANK grads.pt [flags]
_RANK = """
import sys, torch
from torchmdnet_tpu_torch.scripts import train as cli
from torchmdnet_tpu_torch.train.trainer import Trainer

def save(trainer):
    if trainer.state.global_step == 0 and trainer.is_main:
        torch.save({n: p.grad.detach().cpu() for n, p in zip(trainer.param_names, trainer.params)}, sys.argv[1])

Trainer.on_before_optimizer_step = save
cli.main(sys.argv[2:])
"""


def test_cli_ndevices_starts_one_rank_a_device(tmp_path, monkeypatch):
    from torchmdnet_tpu_torch.scripts import train as cli

    calls = []
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(distributed, "launch", lambda argv, n: calls.append((list(argv), n)) or 0)
    flags = TINY + ["--ndevices", "2", "--log-dir", str(tmp_path / "logs"), "--dataset-root", str(tmp_path)]
    assert cli.main(flags) == (None, None)
    assert calls == [(["-m", "torchmdnet_tpu_torch.scripts.train"] + flags, 2)]


def test_two_rank_cli_matches_one_process(tmp_path, monkeypatch):
    import sys

    from torchmdnet_tpu_torch.scripts import train as cli
    from torchmdnet_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {}
    for ranks in ("2", "1"):  # the ranks first: this process trains while nothing else runs
        log_dir = tmp_path / f"logs{ranks}"
        grads = str(tmp_path / f"grads{ranks}.pt")
        flags = TINY + ["--ndevices", ranks, "--log-dir", str(log_dir), "--dataset-root", str(tmp_path / "data")]
        if ranks == "2":  # the ranks as the CLI's launcher starts them, each with the hook
            assert distributed.launch(["-c", _RANK, grads] + flags, 2, timeout=120) == 0
        else:
            def save(trainer, path=grads):
                if trainer.state.global_step == 0:
                    torch.save({n: p.grad.detach().cpu() for n, p in zip(trainer.param_names, trainer.params)},
                               path)

            monkeypatch.setattr(Trainer, "on_before_optimizer_step", save)
            trainer, _ = cli.main(flags)
            assert trainer is not None
        runs[ranks] = (_epochs(log_dir), torch.load(grads))
    (one, g1), (two, g2) = runs["1"], runs["2"]
    assert g1.keys() == g2.keys() and len(g1) > 10
    for name in g1:
        scale = float(g1[name].abs().max())
        assert float((g2[name] - g1[name]).abs().max()) <= 1e-5 * max(scale, 1e-12), name
    assert len(one) == len(two) >= 2  # the epoch and the test
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=0, err_msg=key)
    # only rank 0 wrote checkpoints, one per epoch as one process
    def ckpts(d):
        return sorted(p.split("-val_loss")[0] for p in os.listdir(tmp_path / d) if p.endswith(".ckpt"))

    assert ckpts("logs2") == ckpts("logs1") == ["epoch=0"]
