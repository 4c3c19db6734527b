"""A tiny rehearsal of the cell on the CPU, through the program's plain paths."""

from __future__ import annotations

import torch
from conftest import SOLVE, small_cell

from portbench import run


def test_solve_rehearsal():
    bench, w, c = small_cell("ico9_poisson.c3", **SOLVE)
    out = run.run_cell(bench, "ico9_poisson.c3", w, c, 2**31 + 11, 1.0, False,
                       torch.device("cpu"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 2
    assert set(out["metrics"]) == {"solve_ms", "latency_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks" and set(out["checks"]) == {"resid", "failed"}


def test_same_seed_same_inputs():
    from portbench.lib import fields, meshes

    V, F = meshes.make_mesh({"kind": "icosphere", "order": 2, "unit_area": True})
    V, F = torch.as_tensor(V), torch.as_tensor(F)

    def draw(seed):
        return fields.start_shape(V, F, 0.1, fields.generator(seed, "cpu"))

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(2**31 + 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the noise moves each vertex along its normal by at most a tenth of its edges' length
    _, spacing = fields.vertex_normals_and_spacing(V, F)
    assert bool((torch.linalg.norm(a - V, dim=1) <= 0.1 * spacing + 1e-15).all())
