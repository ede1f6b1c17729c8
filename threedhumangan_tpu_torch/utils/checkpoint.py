"""Step-stamped training checkpoints with keep-interval pruning
(threedhumangan_tpu/utils/checkpoint.py).

Save every N steps as ``{step:08d}_checkpoint.npz``, prune files whose step
is not a multiple of ``keep_interval``, resume from the latest.  The
payload is data only: every tensor leaf is a named npz entry (name = its
path in the payload) and a ``__spec__`` JSON entry records the container
structure (dicts, including the int-keyed ones of an optimizer's
``state_dict``, lists, tuples) and the non-tensor leaves.  Loading unpickles
nothing (``np.load(allow_pickle=False)``); tensors come back on the CPU.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"^(\d{8})_checkpoint\.npz$")


def _encode(node, path: str, arrays: Dict[str, np.ndarray]):
    if isinstance(node, dict):
        keys = list(node.keys())
        return {"t": "dict", "k": keys,
                "c": [_encode(node[k], f"{path}/{k}", arrays) for k in keys]}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "c": [_encode(v, f"{path}/{i}", arrays) for i, v in enumerate(node)]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"t": "py", "v": node}
    name = path.lstrip("/") or "leaf"
    if name in arrays:
        raise ValueError(f"duplicate checkpoint entry {name!r}")
    arrays[name] = np.asarray(node)
    return {"t": "a", "k": name}


def _decode(spec, arrays):
    t = spec["t"]
    if t == "a":
        return torch.from_numpy(np.array(arrays[spec["k"]]))
    if t == "py":
        return spec["v"]
    if t == "dict":
        return {k: _decode(c, arrays) for k, c in zip(spec["k"], spec["c"])}
    if t == "list":
        return [_decode(c, arrays) for c in spec["c"]]
    if t == "tuple":
        return tuple(_decode(c, arrays) for c in spec["c"])
    raise ValueError(f"bad checkpoint spec node {t!r}")


def to_host(payload):
    """A copy of ``payload`` with every tensor as a numpy array (synchronous):
    the train step updates the live tensors in place, so a background write
    must not read them."""
    if isinstance(payload, dict):
        return {k: to_host(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(to_host(v) for v in payload)
    if isinstance(payload, torch.Tensor):
        return payload.detach().cpu().numpy().copy()
    return payload


def save_checkpoint(output_dir: str, step: int, payload: Dict[str, Any],
                    keep_interval: int = 5000) -> str:
    """Write ``payload`` (on the host: ``to_host``) as the step's npz."""
    os.makedirs(output_dir, exist_ok=True)
    prune_checkpoints(output_dir, keep_interval)
    path = os.path.join(output_dir, f"{step:08d}_checkpoint.npz")
    arrays: Dict[str, np.ndarray] = {}
    spec = _encode({"step": step, **payload}, "", arrays)
    tmp = path + ".tmp.npz"  # np.savez appends .npz to unsuffixed names
    with open(tmp, "wb") as f:
        np.savez(f, __spec__=np.asarray(json.dumps(spec)), **arrays)
    os.replace(tmp, path)
    return path


def prune_checkpoints(output_dir: str, keep_interval: int) -> None:
    """Delete auto-saves not on the keep grid."""
    if not os.path.isdir(output_dir):
        return
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m and keep_interval > 0 and int(m.group(1)) % keep_interval != 0:
            os.remove(os.path.join(output_dir, name))


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    steps = sorted((int(m.group(1)), name) for name in os.listdir(output_dir)
                   if (m := _CKPT_RE.match(name)))
    return os.path.join(output_dir, steps[-1][1]) if steps else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload, tensors on the CPU."""
    with np.load(path, allow_pickle=False) as z:
        return _decode(json.loads(str(z["__spec__"])), z)
