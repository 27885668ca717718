"""TT-state checkpoint / resume.

Twin of ``ttnx.utils.checkpoint`` with the same file layout: an ``.npz``
with one array per core (``core_0``, ...) and a ``__meta__`` array holding
JSON (kind, orthogonality flags, core count, and the QTT metadata of
``QTTVector``/``QTTOperator``), so a file written by either package loads
in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.ops.qtt import QTTOperator, QTTVector

__all__ = ["save_tt", "load_tt"]


def save_tt(path: str, tt) -> None:
    """Serialize a TTVector/TTOperator (including QTT subclasses) to
    ``path``; the cores are copied to the host."""
    meta = {
        "kind": ("operator" if isinstance(tt, TTOperator) else "vector"),
        "ot": list(tt.ot),
        "n_cores": tt.N,
    }
    for attr in ("n_dims", "bits_per_dim", "ordering"):
        if hasattr(tt, attr):
            meta[attr] = getattr(tt, attr)
    arrays = {f"core_{i}": c.detach().cpu().numpy()
              for i, c in enumerate(tt.cores)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # numpy appends .npz to the temp name
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)


def load_tt(path: str, *, device):
    """Restore a TT object saved by :func:`save_tt` (either package's), its
    cores on ``device``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        cores = [torch.as_tensor(data[f"core_{i}"], device=device)
                 for i in range(meta["n_cores"])]
    ot = meta.get("ot")
    if meta["kind"] == "operator":
        out = TTOperator(cores, ot)
        if "n_dims" in meta:
            out = QTTOperator(out, meta["n_dims"], meta["bits_per_dim"],
                              meta["ordering"])
        return out
    out = TTVector(cores, ot)
    if "n_dims" in meta:
        out = QTTVector(out, meta["n_dims"], meta["bits_per_dim"],
                        meta["ordering"])
    return out
