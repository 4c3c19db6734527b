"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Registers the ``card`` marker for tests that need a CUDA card. Whether a
card is there is decided inside the ``card`` fixture, never at import, so
every worker collects the same tests.
"""

from __future__ import annotations

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the run needs one")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def pb_cache(tmp_path, monkeypatch):
    """Each test's caches in its own temporary directory."""
    from portbench.lib import cache

    monkeypatch.setattr(cache, "CACHE_DIR", tmp_path / "cache")
    return tmp_path / "cache"


def small_cell(name: str, **changes):
    """(bench, workload, config) of cell ``name`` cut to a CPU test's size:
    ``changes`` update the configuration's mesh recipe and the workload's
    params (keys prefixed ``p_``)."""
    from portbench.run import REPO, load_json
    import json

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    workload = copy.deepcopy(load_json("workloads", name))
    config = copy.deepcopy(load_json("configs", workload["config"]))
    config["name"] = "test_" + config["name"]
    for k, v in changes.items():
        if k.startswith("p_"):
            workload["params"][k[2:]] = v
        else:
            config["mesh"][k] = v
    return bench, workload, config


SOLVE = dict(order=4, p_pool=2, p_samples=2, p_sample_within=4)
