"""On the card, at each cell's own size over a short window: the program
as the configuration states it holds the cell's limits, and through the
cell's own check the control (the reference with every matrix product in
fp8, the step below the bf16 the configurations state) and, for the
scoring cell, each fault of the timed path come out not correct.  The
program's own fp8 expert path is read and printed beside them: no number
of these cells separates it (``PERF.md``).  Skips without a card."""
import json

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(cell, card):
    from portbench.tools import control
    harness.set_cache_dirs()
    program, ctx = control.reading(cell, 20261018, 8.0)
    assert program["correct"], program
    if ctx.cell["driver"] == "scoring_loop":
        got = control.scoring_readings(ctx)
        must_fail = ("fp8_reference", "fault_half_batch", "fault_moe_dropped",
                     "fault_answer_altered")
    else:
        got = control.serving_readings(ctx)
        must_fail = ("fp8_reference",)
    print(json.dumps({"cell": cell, "program": program["checks"], **got}))
    for name in must_fail:
        assert not got[name]["correct"], (name, got[name])
