"""The control (the reference one precision below, fp8, in the program's
place) comes out as not correct under a cell's limits; and, on a card, one
short run of a cell prints a correct result line."""

import json
import os
import subprocess
import sys

import pytest

import tiny
from benchlib import check
from benchlib.config import load_json
from benchlib.control import control_numbers

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cell", ["refcoco-occupancy", "phrasecut-grid64"])
def test_control_fails_the_cell_limits(cell):
    lims = load_json(f"benchmark/limits/{cell}.json")
    multicrop = cell.startswith("phrasecut")  # PhraseCut's crop layer, unstamped, as its cell runs
    per = control_numbers("tiny", 2**31 + 7, device="cpu", bench=tiny.bench(), cfg=tiny.config(multicrop),
                          mix=tiny.mix(stamped=not multicrop))
    got = check.reduce(per)
    assert {k for k in lims if got[k] > lims[k]}, got


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "refcoco-occupancy",
                           "--seed", "2147483713", "--seconds", "3", "--trace", "0"], capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
