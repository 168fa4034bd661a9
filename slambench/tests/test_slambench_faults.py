"""The check sees a broken timed path: the rest of a run, on the CPU at a
tiny size with the cell's own limits, with one fault planted in the
program under it (``slambench.lib.faults``), must come out not correct
(and the unbroken run correct)."""

import pytest

from slambench.lib.faults import FAULTS, faults_for
from slambench.tests.tiny import cpu_run, short_init, tiny_root


@pytest.mark.parametrize("cell", ["tum1.desk", "replica.room0"])
@pytest.mark.parametrize("fault", [None] + faults_for("rgbd"),
                         ids=lambda f: "sound" if f is None else f)
def test_fault_is_caught(tmp_path, monkeypatch, cell, fault):
    short_init(monkeypatch)
    if fault is not None:
        FAULTS[fault](monkeypatch.setattr)
    res = cpu_run(tiny_root(tmp_path, cell), cell)
    failed = {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}
    assert res["correct"] is (fault is None), (failed, res["checks"])
