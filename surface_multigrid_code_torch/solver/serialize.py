"""Save and load the port's device containers (counterpart of ``surface_multigrid_code_tpu/solver/serialize.py``).

A device hierarchy is a deterministic function of the host precompute, but
building it (Galerkin products, colorings, the coarse inverse) costs
seconds at real sizes, so a solver's ``DeviceHierarchy`` or the balloon's
``BsrHierarchy`` can be written once and loaded by a later process:
``save_device_hierarchy`` / ``load_device_hierarchy``, or any nested
structure of the closed set of containers with ``save_pytree`` /
``load_pytree``:

    DeviceHierarchy, DeviceLevel, CSRMatrix, BsrHierarchy, BsrLevel,
    BSRMatrix, dict (str keys), tuple, list, tensor, bool / int / float /
    str, None.

Format: one ``torch.save`` file holding {"spec": a JSON string, "tensors":
the list of tensors, saved from the CPU}. The spec names each container
with the constructor arguments it needs (``n_cols``, ``lam_max``, the GS
groups as a tuple of tensors, the hierarchy's ``perm``), the buffers a
constructor derives (``dinv``, ``iperm``)
and the matrices' ``lanes``, so a load rebuilds the modules and then
restores every tensor as saved, bit for bit and with its dtype (float64 and
int64 included). ``torch.load(weights_only=True)`` reads it: nothing but
tensors, lists, dicts and strings is unpickled.

The JAX package's device npz (windowed TPU layouts, ELL fallbacks) does
not load here: the port's containers are CSR / BSR-CSR and the two
formats share nothing. The host hierarchy (``solver/hierarchy.save_hierarchy``)
and the collapse log (``ssp/decimate.save_log``) are the formats both
packages read.
"""

from __future__ import annotations

import json

import torch
from torch import nn

from surface_multigrid_code_torch.utils.device import resolve_device


def _registry() -> dict:
    """{name: (class, its constructor's arguments in order, the buffers the
    constructor derives from them)}."""
    from surface_multigrid_code_torch.ops.sparse import BSRMatrix, CSRMatrix
    from surface_multigrid_code_torch.solver.bsr import BsrHierarchy, BsrLevel
    from surface_multigrid_code_torch.solver.vcycle import DeviceHierarchy, DeviceLevel

    return {
        "CSRMatrix": (CSRMatrix, ("indptr", "indices", "data", "n_cols"), ()),
        "BSRMatrix": (BSRMatrix, ("indptr", "indices", "blocks", "n_cols"), ()),
        "DeviceLevel": (DeviceLevel, ("A", "diag", "P", "PT", "groups", "lam_max"), ("dinv",)),
        "DeviceHierarchy": (DeviceHierarchy, ("levels", "coarse_inv", "perm"), ("iperm",)),
        "BsrLevel": (BsrLevel, ("A", "diag", "P", "PT", "lam_max"), ("dinv",)),
        "BsrHierarchy": (BsrHierarchy, ("levels", "coarse_inv"), ()),
    }


def _encode(obj, tensors: list):
    for name, (cls, args, derived) in _registry().items():
        if type(obj) is cls:
            spec = {"t": name, "args": [_encode(getattr(obj, a), tensors) for a in args]}
            if derived:
                spec["buffers"] = {k: _encode(getattr(obj, k), tensors) for k in derived}
            if hasattr(obj, "lanes"):
                spec["lanes"] = obj.lanes
            return spec
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, torch.Tensor):
        tensors.append(obj.detach().cpu().clone())
        return {"t": "tensor", "i": len(tensors) - 1}
    if isinstance(obj, (tuple, list, nn.ModuleList)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "c": [_encode(c, tensors) for c in obj]}
    if isinstance(obj, dict):
        if any(not isinstance(k, str) for k in obj):
            raise TypeError("only str dict keys are serializable")
        keys = sorted(obj)
        return {"t": "dict", "k": keys, "c": [_encode(obj[k], tensors) for k in keys]}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "v": obj}
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _decode(spec, tensors: list, device):
    t = spec["t"]
    if t == "none":
        return None
    if t == "tensor":
        return tensors[spec["i"]].to(device)
    if t == "lit":
        return spec["v"]
    if t in ("tuple", "list"):
        seq = [_decode(c, tensors, device) for c in spec["c"]]
        return tuple(seq) if t == "tuple" else seq
    if t == "dict":
        return {k: _decode(c, tensors, device) for k, c in zip(spec["k"], spec["c"])}
    cls = _registry()[t][0]
    obj = cls(*(_decode(a, tensors, device) for a in spec["args"]))
    for k, b in spec.get("buffers", {}).items():
        setattr(obj, k, _decode(b, tensors, device))
    if "lanes" in spec:
        obj.lanes = spec["lanes"]
    return obj


def save_pytree(path, obj) -> None:
    """Write any nested structure of the containers above to ``path``."""
    tensors: list = []
    spec = _encode(obj, tensors)
    torch.save({"spec": json.dumps(spec), "tensors": tensors}, path)


def load_pytree(path, device="cuda"):
    """Read what ``save_pytree`` wrote, every tensor on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return _decode(json.loads(saved["spec"]), saved["tensors"], device)


def save_device_hierarchy(path, hier) -> None:
    """Write a ``DeviceHierarchy`` or ``BsrHierarchy`` (every level's
    operators, diagonals, GS groups, Chebyshev bounds, the coarse inverse
    and a ``DeviceHierarchy``'s row ordering) to ``path``."""
    save_pytree(path, hier)


def load_device_hierarchy(path, device="cuda"):
    """Read a hierarchy ``save_device_hierarchy`` wrote, onto ``device``."""
    return load_pytree(path, device)
