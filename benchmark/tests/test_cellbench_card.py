"""On the card, at each cell's own size: the check's control (the reference
in the cell's control precision, put in the program's place) comes out not
correct against the cell's limits, and the program on the same seed
comes out correct."""

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda

CELLS = ["res.train_b16_bf16", "swin.train_b1", "res.serve_compact"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    c = harness.load_cell(cell)
    d = harness.load_runner(c.traffic["runner"])(c, card, 2147483901)
    d.setup()
    if d.unit == "slice":
        d.window(5.0)
    d.free()
    ref = d.reference(d.precision)
    low = d.reference(harness.CONTROL_BELOW[d.precision])
    control = (d.control_side(low) if d.unit == "slice"
               else {**low, "batches": low["batches"][:1]})
    limits = c.traffic["limits"]
    over = {k: v for k, v in d.readings(control, ref).items()
            if k in limits and v > limits[k]}
    assert over, "the control passed every limit"
    program = d.readings(d.program_side(), ref)
    assert all(v <= limits[k] for k, v in program.items() if k in limits), \
        program
    torch.cuda.empty_cache()
