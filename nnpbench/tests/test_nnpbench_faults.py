"""Runs with the timed path broken underneath: the rest of the run (set-up,
window, check) as the benchmark drives it, at a CPU size, and ``correct``
must come out false for each fault the cell can have.  A one-chip cell has
no exchange between chips to leave out.  A sound run at the same size
comes out true."""

import pytest
import torch

from nnpbench.tests import tiny


def test_sound_md_run_is_correct():
    assert tiny.run("et-md-calls")["correct"]


def _calls_fault(monkeypatch, fault):
    from torchmdnet_tpu_torch.calculators import External

    real = External.calculate
    last = {}

    def broken(self, pos, box=None):
        y, f = real(self, pos, box)
        if fault == "unchanged_state":  # the previous call's answer returned again
            y, f, last["y"], last["f"] = last.get("y", y), last.get("f", f), y, f
        elif fault == "half_left_out":  # the second half of the atoms' forces never computed
            n = f.shape[1]
            f = torch.cat([f[:, : n // 2], torch.zeros_like(f[:, n // 2:])], dim=1)
        elif fault == "altered_answer":  # one atom's force altered where it is produced
            f = f.clone()
            f[0, 0] += 10.0
        return y, f

    monkeypatch.setattr(External, "calculate", broken)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_left_out", "altered_answer"])
def test_calls_fault_is_not_correct(monkeypatch, fault):
    _calls_fault(monkeypatch, fault)
    r = tiny.run("et-md-calls")
    assert not r["correct"], r["checks"]
