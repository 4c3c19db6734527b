"""The command: no result without a card; on a card, a short run of a cell is correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.run import REPO


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ico9_poisson.c3", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_short_run_on_the_card(card):
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "ico9_poisson.c3",
                          "--seed", str(2**31 + 41), "--seconds", "3", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
