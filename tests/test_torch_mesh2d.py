"""``parallel.mesh.make_2d_mesh`` (counterpart of the JAX package's dp x mp
mesh) on the CPU: the layout without a process group, a rank's row and
column in a 2 x 3 group (``torch.distributed`` stood in for), and its two
subgroups in a one-rank gloo group."""

import pytest
import torch
import torch.distributed as dist

from torchmdnet_tpu_torch.parallel.mesh import make_2d_mesh


def test_layout_without_a_process_group():
    assert make_2d_mesh(1, 1) == ((0, 0), None, None)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_2d_mesh(2, 1)


def test_a_rank_sees_its_row_and_column(monkeypatch):
    made = []

    def new_group(ranks):
        made.append(ranks)
        return tuple(ranks)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 6)
    monkeypatch.setattr(dist, "get_rank", lambda: 4)
    monkeypatch.setattr(dist, "new_group", new_group)
    coords, dp_group, mp_group = make_2d_mesh(2, 3)
    assert coords == (1, 1) and dp_group == (1, 4) and mp_group == (3, 4, 5)
    # every rank creates every group, in the same order
    assert made == [[0, 3], [1, 4], [2, 5], [0, 1, 2], [3, 4, 5]]


def test_subgroups_in_a_gloo_group(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        coords, *groups = make_2d_mesh(1, 1)
        assert coords == (0, 0) and all(group is not None for group in groups)
        for group in groups:
            x = torch.ones(3)
            dist.all_reduce(x, group=group)
            assert dist.get_world_size(group) == 1 and torch.equal(x, torch.ones(3))
    finally:
        dist.destroy_process_group()
