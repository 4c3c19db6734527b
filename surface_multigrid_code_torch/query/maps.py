"""Bidirectional point queries through the SSP collapse log on the host (ports ``surface_multigrid_code_tpu/query/maps.py``).

Semantics follow the reference exactly:

- ``query_fine_to_coarse`` (src/query_fine_to_coarse.cpp): push (BC, BF,
  FIdx) query points given on the FINE mesh forward through every collapse
  whose pre-patch contained their current face, in increasing collapse
  order; at each step evaluate the point in UV_pre, re-barycentrize in
  UV_post with a max-min-barycentric snap (clamp negatives, renormalize,
  :90-118), then finally reindex vertex ids through IM and face ids
  through FIM (:132-151).
- ``query_coarse_to_fine`` (src/query_coarse_to_fine.cpp): first map
  coarse indices to original ids via IM/IMF (:22-36), then walk collapses
  in DECREASING order mapping UV_post -> UV_pre.

The walks run in the native engine (OpenMP over queries, the analog of
the reference's igl::parallel_for grain-1000 fan-out). ``query/device.py``
runs the same walks on the card (K5).
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


def query_coarse_to_fine(log: dict, BC, BF, FIdx):
    """Walk coarse-mesh points back to the fine mesh.

    BF: coarse vertex ids, FIdx: coarse face ids on input; fine ids on
    output.
    """
    BC = np.array(BC, dtype=np.float64, copy=True)
    BF = np.array(BF, dtype=np.int64, copy=True)
    FIdx = np.array(FIdx, dtype=np.int64, copy=True)
    # coarse ids -> working-mesh ids (reference :22-36)
    BF = log["IM"][BF]
    FIdx = log["IMF"][FIdx]
    BC, BF, FIdx = _native.query_walk(log, False, BC, BF, FIdx)
    return BC, BF, FIdx
