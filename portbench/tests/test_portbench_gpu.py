"""On the card, at a cell's own size: a sound run is correct, and each
control (the program's path without the segment index; the program at
level 9 with level 6's matcher depth) is not."""

import contextlib
import time

import pytest

from portbench import control, harness

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("which", ["sound", "no_index", "shallow"])
def test_cell_and_controls_on_the_card(cuda, which):
    cell = harness.load_cell("gzip-l9.mixed-16m")
    if which == "no_index":
        cell.config = dict(cell.config, segment_index=False)
    planted = control.shallow(9) if which == "shallow" else contextlib.nullcontext()
    with planted:
        r = harness.run_cell(cell, 2**31 + 2024, 3.0, False, t_start=time.perf_counter(),
                             log=lambda m: None)
    assert r["correct"] is (which == "sound")
    if which == "no_index":
        assert r["checks"]["segments"]["value"] >= 64 * 2048
    if which == "shallow":
        assert r["checks"]["short_matches"]["value"] > 0
