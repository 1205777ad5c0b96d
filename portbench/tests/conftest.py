"""Fixtures of the benchmark's own tests (run them with
`python -m pytest portbench/tests` from the repository root)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the CPU runs' size: big enough that every query has its full answer
# (Q3's ten rows, orders with quantity sums above bfloat16's 256)
TINY_SF = 0.01


@pytest.fixture
def run_cpu():
    """run_cpu(cell, hooks=None, seconds=1.0) -> (result, checks): one
    run of a cell on the CPU at TINY_SF, past the harness's look for a
    card."""
    from portbench import cell, spec

    def run(name, hooks=None, seconds=1.0, seed=20260101):
        c = spec.find_cell(name)
        return cell.run_cell(c, seed, seconds, False, device="cpu",
                             sf=TINY_SF, hooks=hooks)

    return run


@pytest.fixture
def card():
    """The tests marked `cuda` run on a card only: decided here, never
    while the module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.cuda.get_device_name(0)
