"""Fine-to-coarse point queries through the SSP collapse log (ports ``query_fine_to_coarse`` of ``surface_multigrid_code_tpu/query/maps.py``).

Semantics follow reference src/query_fine_to_coarse.cpp: push (BC, BF,
FIdx) query points given on the fine mesh forward through every collapse
whose pre-patch contained their current face, in increasing collapse
order, then reindex vertex ids through IM and face ids through FIM
(:132-151). The walk runs in the native engine (OpenMP over queries).
"""

from __future__ import annotations

import numpy as np

from surface_multigrid_code_torch.ssp import _native


def query_fine_to_coarse(log: dict, BC, BF, FIdx):
    """Walk fine-mesh points to the coarse mesh.

    BC: (n,3) barycentric; BF: (n,3) fine vertex ids; FIdx: (n,) fine face
    ids.  Returns updated (BC, BF, FIdx) with BF in coarse vertex ids and
    FIdx in coarse face ids.
    """
    BC = np.array(BC, dtype=np.float64, copy=True)
    BF = np.array(BF, dtype=np.int64, copy=True)
    FIdx = np.array(FIdx, dtype=np.int64, copy=True)
    BC, BF, FIdx = _native.query_walk(log, True, BC, BF, FIdx)
    # working-mesh ids -> coarse ids (reference :132-151)
    IM = log["IM"]
    index_map = np.zeros(int(IM.max()) + 1, dtype=np.int64)
    index_map[IM] = np.arange(IM.shape[0])
    BF = index_map[BF]
    FIdx = log["FIM"][FIdx]
    return BC, BF, FIdx
