"""On a card: the queue cell's run, short, through the harness's own look
for the card, with `correct` true. Skips without a card."""

import time

import pytest

from port_bench import run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["queue-10k-w100"])
def test_queue_cell_on_the_card(cell, card):
    out = run.run_cell(cell, 2**31 + 41, 2.0, False, t_start=time.perf_counter())
    assert out["correct"] and out["device"]["platform"] == "gpu"
