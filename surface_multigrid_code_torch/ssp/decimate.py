"""SSP decimation and the collapse log's npz (ports ``surface_multigrid_code_tpu/ssp/decimate.py``).

Mirrors reference `SSP_decimate` (src/SSP_decimate.cpp:3-40): rejects
non-manifold input, dispatches on dec_type (0=qslim, 1=midpoint,
2=vertex removal), returns the coarse mesh, birth maps and the
successive-self-parameterization log. The log is a dict of flat numpy
arrays (CSR-style offsets) consumed by the native and device query walks,
and saved as an npz (``save_log`` / ``load_log``) in the JAX package's
format, so a log either package writes loads in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from surface_multigrid_code_torch.config import DecimationType
from surface_multigrid_code_torch.ssp import _native
from surface_multigrid_code_torch.utils.profiler import profile_region

#: keys of the flattened collapse log (everything query walks need)
LOG_KEYS = (
    "b", "voff", "subset", "uv_pre", "uv_post",
    "foff_pre", "fuv_pre", "fidx_pre",
    "foff_post", "fuv_post", "fidx_post",
    "dim_off", "dim_dat", "IM", "IMF", "FIM",
)


def SSP_decimate(
    VO: np.ndarray,
    FO: np.ndarray,
    tarF: int,
    dec_type: DecimationType = DecimationType.MIDPOINT,
    seed: int | None = None,
    verbose: bool = False,
):
    """Decimate (VO, FO) to ~tarF faces with SSP bookkeeping.

    Returns (ok, V, F, IMF, IM, log):
      V, F - coarse mesh;
      IMF  - coarse face -> original face id (reference J);
      IM   - coarse vertex -> original vertex id (reference I);
      log  - flattened collapse log dict (includes IM/IMF/FIM for queries).
    """
    with profile_region("SSP: decimate"):
        out = _native.decimate(
            VO, FO, int(tarF), int(dec_type),
            random_variant=seed is not None,
            seed=0 if seed is None else int(seed),
            verbose=verbose,
        )
    if out is None:
        return False, None, None, None, None, None
    log = {k: out[k] for k in LOG_KEYS}
    return True, out["V"], out["F"], out["IMF"], out["IM"], log


def save_log(path: str | Path, log: dict) -> None:
    """Serialize a collapse log (the hierarchy checkpoint the reference
    never persists)."""
    np.savez_compressed(path, **log)


def load_log(path: str | Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
