"""The check on the card, through the CUDA kernels: a sound run of each
cell is correct, its control is not. At sizes that a test run holds (the
control's at the least that lets float32 fall short); the full-size runs
are the benchmark's own and `python3 -m portbench.control`'s. Skips
without a card."""
import time

import pytest
import torch

from portbench import layout, run

from portbench.tests.test_portbench_controls import CONTROL

SEED = 2**31 + 21
SOUND = {
    "lsd.keys.2e30": {"config": {"table_rows": 1 << 24}},
    "tpch30.join": {"config": {"scale_factor": 1}},
    "tpch30.q1": {"config": {"scale_factor": 1}},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _run(cell, overrides, device, call=None):
    return run.run_cell(cell, SEED, 0.5, False, start=time.perf_counter(),
                        device=device, overrides=overrides, call=call)


@pytest.mark.parametrize("cell", sorted(SOUND))
def test_a_sound_run_on_the_card_is_correct(cell, card):
    r = _run(cell, SOUND[cell], card)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_control_on_the_card_is_not_correct(cell, card):
    ref = layout.module("reference", layout.workload(cell)["reference"])
    r = _run(cell, CONTROL[cell], card, call=ref.control)
    assert r["correct"] is False, r["checks"]
