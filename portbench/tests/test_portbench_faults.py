"""Whole runs of a small cell on the CPU, the chip's look skipped: a sound
run is correct; the control and each fault a block-encode cell can have,
planted under the timed path, are not. (One chip: there is no exchange
between chips to leave out.)"""

import time

import pytest
from _small import small_cell

from portbench import control, harness
from portbench.faults import FAULTS


def run(cell, wrap_step=None, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 0.6, False, t_start=time.perf_counter(), device="cpu",
                            wrap_step=wrap_step, log=lambda m: None)


def test_sound_run_is_correct():
    r = run(small_cell())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_come_out_incorrect(fault):
    r = run(small_cell(pool=2), wrap_step=FAULTS[fault])
    assert not r["correct"] and r["failed"] > 0


def test_control_without_the_segment_index():
    """The control: the program's own path without the segment index, a
    guarantee the configuration states."""
    cell = small_cell()
    cell.config = dict(cell.config, segment_index=False)
    r = run(cell)
    assert not r["correct"]
    assert r["checks"]["segments"]["value"] >= (1 << 17) // 128
    assert all(r["checks"][k]["value"] == 0 for k in ("framing", "blocks", "wrong_bytes"))


@pytest.mark.parametrize("name", ["gzip-l9.mixed-16m", "gzip-l6.logs-16m"])
def test_control_with_a_shallower_matcher(name):
    """The control: the program at its level with the depth of the level
    three below; the level's matcher is a guarantee the configuration
    states. A sound run of the same cell is correct."""
    cell = small_cell(name)
    assert run(cell)["correct"]
    with control.shallow(int(cell.config["level"])):
        r = run(cell)
    assert not r["correct"] and r["checks"]["short_matches"]["value"] > 0
    assert all(r["checks"][k]["value"] == 0 for k in ("framing", "blocks", "wrong_bytes",
                                                       "segments", "witness"))
