"""Carry a compiled model, or a batch of state, across from numpy arrays.

`model_from_numpy` builds the port's `Model` from a model compiled elsewhere
(for instance by the JAX package) and handed over as plain data: `fields`
maps every array field name to a numpy array, `meta` maps every static field
name to its int / tuple / str value. Option fields use an `opt.` prefix in
both dicts (`fields["opt.gravity"]`, `meta["opt.iterations"]`). Arrays land
on the CPU as float64 (integers keep their dtype); `Model.to` moves them.

`data_from_numpy` builds the port's batch-first `Data` the same way: every
array field (B, ...) by name, the contact arrays as `contact.<name>` and the
contact slots' static geom ids and condims in `meta`. Arrays keep their
dtype, so a float32 batch stays float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core import types


def _tensor(name: str, arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        a = a.astype(np.float64)
    elif a.dtype.kind not in "iub":
        raise ValueError(f"field '{name}': unsupported dtype {a.dtype}")
    return torch.as_tensor(a.copy())


def _static(value):
    """Normalize numpy scalars / nested sequences into plain ints/tuples."""
    if isinstance(value, (tuple, list)):
        return tuple(_static(v) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    return value


def _build(cls, fields: dict, meta: dict, prefix: str):
    kw = {}
    for name in types.array_fields(cls):
        key = prefix + name
        if key not in fields:
            raise ValueError(f"model_from_numpy: missing array field '{key}'")
        kw[name] = _tensor(key, fields[key])
    for name in types.static_fields(cls):
        key = prefix + name
        if key not in meta:
            raise ValueError(f"model_from_numpy: missing static field '{key}'")
        kw[name] = _static(meta[key])
    return cls(**kw)


def model_from_numpy(fields: dict, meta: dict) -> types.Model:
    opt = _build(types.Option, fields, meta, "opt.")
    m = _build(types.Model, fields, meta, "")
    return dataclasses.replace(m, opt=opt)


def data_from_numpy(fields: dict, meta: dict) -> types.Data:
    def arr(key):
        if key not in fields:
            raise ValueError(f"data_from_numpy: missing array field '{key}'")
        a = np.asarray(fields[key])
        if a.dtype.kind not in "fiub":
            raise ValueError(f"field '{key}': unsupported dtype {a.dtype}")
        return torch.as_tensor(a.copy())

    static = ("geom1", "geom2", "dim")
    ckw = {f.name: arr("contact." + f.name)
           for f in dataclasses.fields(types.Contact) if f.name not in static}
    for name in static:
        ckw[name] = _static(meta["contact." + name])
    kw = {f.name: arr(f.name) for f in dataclasses.fields(types.Data)
          if f.name != "contact"}
    return types.Data(contact=types.Contact(**ckw), **kw)
