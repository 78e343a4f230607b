"""The tests' cells: `BENCHMARK.json`'s and those held out of it
(`held_out_cells.json`), loaded by `run.load_cell`."""

from __future__ import annotations

import json
import os

from slam_bench import run

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = ("tum3_slam.corridor", "tum3_loc.revisit")


def load(name: str) -> dict:
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(HERE, "held_out_cells.json")) as f:
        held = json.load(f)
    spec["configs"] += held["configs"]
    spec["workloads"] += held["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [w["name"]
                                               for w in held["workloads"]]
    return run.load_cell(name, spec=spec)
