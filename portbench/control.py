"""Readings for the limits of ``correct``: a cell's compared numbers over
many seeds of the program, and over seeds of its control, in one process.

    python3 portbench/control.py --workload gzip-l6.mixed-16m --seeds 12 \
        --control-seeds 3 --seconds 6

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the judgement) at its own size. The configuration states no precision, so
each control breaks a guarantee it states, and has to come out incorrect:
``no_index``, the program's own path with the segment index switched off
(``segment_index`` false); ``shallow``, the program at its level with the
matcher's depth of the level three below (level 9 at level 6's 16, level
6 at level 3's 8), set in the program's ladder for this process. Then,
with ``--faults 1``, each fault of ``faults.py`` on the control's seeds.
The benchmark's runs never run these. Prints one JSON line a run and,
last, the largest reading of each number over the sound runs and the
smallest over each control's and each fault's.
"""

import contextlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402


@contextlib.contextmanager
def shallow(level: int):
    """The program's ladder with ``level`` at the depth of ``level - 3``."""
    from compu_tpu_torch.kernels import block_codec

    saved = dict(block_codec.DEV_DEPTH)
    block_codec.DEV_DEPTH[level] = saved[max(1, level - 3)]
    try:
        yield
    finally:
        block_codec.DEV_DEPTH.update(saved)


def readings(cell, seeds, seconds: float, fault: str | None = None) -> list[dict]:
    out = []
    for seed in seeds:
        r = harness.run_cell(cell, seed, seconds, False, t_start=time.perf_counter(),
                             log=lambda m: None, wrap_step=FAULTS.get(fault or ""))
        row = {"seed": seed, "fault": fault, "correct": r["correct"], "attempted": r["attempted"],
               "checks": {k: c["value"] for k, c in r["checks"].items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 40000)
    ap.add_argument("--faults", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch

    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    sound = readings(cell, seeds, args.seconds)
    cseeds = seeds[:args.control_seeds]
    no_index = harness.load_cell(args.workload)
    no_index.config = dict(no_index.config, segment_index=False)
    controls = {"no_index": readings(no_index, cseeds, args.seconds)}
    with shallow(int(cell.config["level"])):
        controls["shallow"] = readings(cell, cseeds, args.seconds, "shallow")
    if args.faults:
        controls.update({f: readings(cell, cseeds, args.seconds, f) for f in FAULTS})
    keys = sound[0]["checks"]
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(r["checks"][k] for r in sound) for k in keys},
        "sound_correct": sum(r["correct"] for r in sound), "sound_runs": len(sound),
        "upper": {c: {k: min(r["checks"][k] for r in rows) for k in keys}
                  for c, rows in controls.items() if rows},
        "incorrect": {c: sum(not r["correct"] for r in rows) for c, rows in controls.items()},
        "runs": {c: len(rows) for c, rows in controls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
