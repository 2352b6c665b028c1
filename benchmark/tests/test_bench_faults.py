"""The rest of a run with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have (``benchmark.faults``),
through the rehearsal path (the card's look skipped) at the tiny size."""

import pytest

from benchmark import faults, spec
from benchmark.rehearse import rehearse

CASES = [(w["name"], kind) for w in spec.load()["workloads"]
         for kind in faults.KINDS[spec.cell(w["name"]).job]]


@pytest.mark.parametrize("cell,kind", CASES)
def test_fault_is_not_correct(cell, kind):
    with faults.planted(spec.cell(cell).job, kind):
        result = rehearse(cell, seed=21, seconds=0.3)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load()["workloads"]])
def test_sound_run_is_correct(cell):
    assert rehearse(cell, seed=21, seconds=0.3)["correct"]
