"""The rest of a run with the timed path broken underneath: ``correct``
comes out false for each fault a cell's job declares
(``benchmark.faults``), through the rehearsal path (the card's look
skipped) at the tiny size.  A rehearsal runs a fixed number of units, so
a fault that leaves the first batch right always meets a second."""

import pytest

from benchmark import faults, spec
from benchmark.rehearse import rehearse

CASES = [(w["name"], kind) for w in spec.load()["workloads"]
         for kind in faults.kinds(spec.cell(w["name"]).job)]


@pytest.mark.parametrize("cell,kind", CASES)
def test_fault_is_not_correct(cell, kind):
    with faults.planted(spec.cell(cell).job, kind):
        result = rehearse(cell, seed=21)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load()["workloads"]])
def test_sound_run_is_correct(cell):
    assert rehearse(cell, seed=21)["correct"]


def test_qwen_jobs_declare_their_faults():
    assert faults.kinds("capture") == ("half_batch", "answer_altered", "state_unchanged")
    assert faults.kinds("train") == ("state_unchanged", "half_batch")
    with pytest.raises(ValueError, match="no fault"):
        with faults.planted("train", "answer_altered"):
            pass
