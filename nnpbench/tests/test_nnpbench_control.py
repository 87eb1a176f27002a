"""The controls of the correctness check: the reference put in the
program's place with its edge phase rounded to float8 must come out as not
correct, on three seeds.  At a CPU size here (the configuration's own
widths, a thousand atoms); ``test_control_at_the_cells_size`` runs the same
at the cell's own size where a card is present (``python -m pytest
nnpbench/tests -k cells_size`` on the card), and skips here."""

import pytest
import torch

from nnpbench.tests import tiny
from nnpbench import control, harness


def _fails(cell, numbers):
    _, ok = harness.check_numbers(cell, numbers)
    return not ok


@pytest.mark.parametrize("seed", [3, 4, 2147483659])
def test_calls_control_is_not_correct(seed):
    cell = tiny.cell("et-md-calls", seed=seed, widths="configuration", n_atoms=1000)
    assert _fails(cell, control.calls_numbers(cell, "fp8"))


def test_bf16_stand_in_is_correct():
    """The reference rounded where the port rounds (bfloat16) stays within
    the limits: the control fails for its precision, not for the stand-in."""
    cell = tiny.cell("et-md-calls", seed=6, widths="configuration")
    assert not _fails(cell, control.calls_numbers(cell, "bf16"))


def test_control_at_the_cells_size(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    for seed in (21, 22, 23):
        cell = control.cell_of("et-md-calls", seed, str(tmp_path))
        numbers = control.calls_numbers(cell, "fp8")
        assert _fails(cell, numbers), numbers
