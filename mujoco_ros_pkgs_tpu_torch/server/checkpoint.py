"""Checkpoint / resume of a server's batched state.

Counterpart of mujoco_ros_pkgs_tpu/server/checkpoint.py, in its numpy
format: <path>.json, a manifest (model name, nenv, sim time, one spec per
array: field, dtype, shape), and <path>.bin, a "PYFB" blob (the array
bytes, each after its length as 8 little-endian bytes). The arrays are the
integrated state of _STATE_FIELDS, then the state of the server's
generator (the port's counterpart of the JAX batch's per-env keys, so that
a resumed run draws the same plugin and control noise), then the plugins'
states. Activations (`act`) are not stored: the port compiles no model
with activation state. A blob of the JAX package's native codec is
refused.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np
import torch

_STATE_FIELDS = ("time", "qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied",
                 "eq_active", "mocap_pos", "mocap_quat", "qacc_warmstart")
_GENERATOR = "__generator"
_MAGIC = b"PYFB"


def _pstate_items(pstates):
    """(name, tensor) of every plugin-state tensor, in plugin order."""
    for i, ps in enumerate(pstates):
        items = ps.items() if isinstance(ps, dict) else enumerate(ps)
        for key, t in items:
            yield f"__pstate_{i}_{key}", t


def _flatten(server) -> Tuple[List[np.ndarray], List[dict]]:
    named = [(f, getattr(server.d, f)) for f in _STATE_FIELDS]
    named.append((_GENERATOR, server._generator.get_state()))
    named += list(_pstate_items(server.pstates))
    arrays, specs = [], []
    for name, t in named:
        a = np.ascontiguousarray(t.detach().cpu().numpy())
        arrays.append(a)
        specs.append({"field": name, "dtype": str(a.dtype), "shape": list(a.shape)})
    return arrays, specs


def _pack(arrays: List[np.ndarray]) -> bytes:
    out = bytearray(_MAGIC)
    for a in arrays:
        b = a.tobytes()
        out += len(b).to_bytes(8, "little") + b
    return bytes(out)


def _unpack(blob: bytes, specs: List[dict]) -> List[np.ndarray]:
    if blob[:4] != _MAGIC:
        raise ValueError("checkpoint blob is not in the numpy format (PYFB); the "
                         "native state codec's blobs are not supported by the port")
    arrays, off = [], 4
    for s in specs:
        n = int.from_bytes(blob[off:off + 8], "little")
        off += 8
        arrays.append(np.frombuffer(blob[off:off + n], dtype=np.dtype(s["dtype"]))
                      .reshape(s["shape"]).copy())
        off += n
    return arrays


def save(server, path: str) -> None:
    """Write the server's batch, generator and plugin states to path.json and
    path.bin (under the server's lock: a consistent snapshot)."""
    with server._lock:
        arrays, specs = _flatten(server)
        manifest = {"model": server.m.name, "nenv": server.nenv,
                    "sim_time": server.sim_time, "arrays": specs}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    with open(path + ".bin", "wb") as f:
        f.write(_pack(arrays))


def load(server, path: str) -> None:
    """Restore a checkpoint of the same model and nenv into the server: the
    integrated state, the generator and the plugins' states (ValueError on
    a mismatch, before anything changes)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest["nenv"] != server.nenv:
        raise ValueError(f"checkpoint nenv {manifest['nenv']} != server nenv {server.nenv}")
    if manifest["model"] != server.m.name:
        raise ValueError(f"checkpoint model '{manifest['model']}' != loaded model "
                         f"'{server.m.name}'")
    with open(path + ".bin", "rb") as f:
        arrays = dict(zip((s["field"] for s in manifest["arrays"]),
                          _unpack(f.read(), manifest["arrays"])))
    with server._lock:
        plugin = list(_pstate_items(server.pstates))
        if sorted(arrays) != sorted([*_STATE_FIELDS, _GENERATOR, *(k for k, _ in plugin)]):
            raise ValueError("checkpoint fields do not match the server's state and "
                             "plugins")
        for name, t in [(f, getattr(server.d, f)) for f in _STATE_FIELDS] + plugin:
            if tuple(arrays[name].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {name} shape {arrays[name].shape} != "
                                 f"{tuple(t.shape)}")

        def put(name, like):
            return torch.from_numpy(arrays[name]).to(device=like.device, dtype=like.dtype)
        d = server.d.replace(**{f: put(f, getattr(server.d, f)) for f in _STATE_FIELDS})
        pstates = []
        for i, ps in enumerate(server.pstates):
            if isinstance(ps, dict):
                pstates.append({k: put(f"__pstate_{i}_{k}", t) for k, t in ps.items()})
            else:
                pstates.append(tuple(put(f"__pstate_{i}_{k}", t) for k, t in enumerate(ps)))
        server.d, server.pstates = d, tuple(pstates)
        server._generator.set_state(torch.from_numpy(arrays[_GENERATOR]))
        server._applied = bool((d.xfrc_applied != 0).any() or (d.qfrc_applied != 0).any())
        server._needs_forward = True
