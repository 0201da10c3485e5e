"""The env batch split over a list of devices of one process.

Counterpart of mujoco_ros_pkgs_tpu/parallel/mesh.py. The JAX package shards
the batch's leading axis over a `jax.sharding.Mesh` and lets XLA place the
collectives; here a mesh is a list of torch devices and the batch is split
in order, one shard a device, each shard stepped on its own device by
ops/forward.step with the model cast there. The consumer (BASELINE config
5's "sharded consumer fed via collectives") is the global mean qpos and
mean time, formed from the shards' sums on the first device.

On one card the list is [cuda:0]; the CPU tests pass eight CPU devices, as
the JAX package's tests use eight virtual ones. Across processes, see
parallel/multihost.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a batch is split over: `devices`, else every CUDA device
    (the CPU where there is none), the first `n_devices` of them."""
    if devices is None:
        count = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(count)] if count else ["cpu"]
    devs = [torch.device(d) for d in devices]
    return devs[:n_devices or len(devs)]


def replicate_model(m: Model, mesh: Sequence[torch.device]) -> List[Model]:
    """The model on every device of the mesh (one cast a distinct device)."""
    cast: Dict[torch.device, Model] = {}
    for dev in mesh:
        if dev not in cast:
            cast[dev] = m.to(dev)
    return [cast[dev] for dev in mesh]


def split_batch(tree, sizes: Sequence[int]) -> list:
    """tree (a Data, a plugin state: dicts, tuples and dataclasses of tensors
    batched on dim 0) cut into consecutive pieces of `sizes` envs; what is
    not a tensor (a contact set's static pair lists) is shared."""
    if torch.is_tensor(tree):
        return list(torch.split(tree, list(sizes)))
    if isinstance(tree, dict):
        parts = {k: split_batch(v, sizes) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(len(sizes))]
    if isinstance(tree, (tuple, list)):
        parts = [split_batch(v, sizes) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(len(sizes))]
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        parts = {n: split_batch(getattr(tree, n), sizes) for n in names}
        return [dataclasses.replace(tree, **{n: parts[n][i] for n in names})
                for i in range(len(sizes))]
    return [tree] * len(sizes)


def concat_batch(pieces: Sequence, device=None):
    """split_batch's inverse: the pieces joined on dim 0 (on `device`, else
    on the first piece's)."""
    first = pieces[0]
    if torch.is_tensor(first):
        dev = device if device is not None else first.device
        return torch.cat([p.to(dev) for p in pieces])
    if isinstance(first, dict):
        return {k: concat_batch([p[k] for p in pieces], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(concat_batch(list(col), device) for col in zip(*pieces))
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: concat_batch([getattr(p, f.name) for p in pieces], device)
            for f in dataclasses.fields(first)})
    return first


def shard_sizes(nenv: int, nshard: int) -> List[int]:
    """nenv envs in nshard equal shards (ValueError when it does not divide)."""
    if nenv % nshard:
        raise ValueError(f"nenv={nenv} not divisible by {nshard} shards")
    return [nenv // nshard] * nshard


def shard_batch(tree, mesh: Sequence[torch.device], nenv: Optional[int] = None) -> list:
    """The batch (of nenv envs: a Data's by default) split in order into one
    shard a device, each on its device."""
    nenv = batch_size(tree) if nenv is None else nenv
    pieces = split_batch(tree, shard_sizes(nenv, len(mesh)))
    return [_to(p, dev) for p, dev in zip(pieces, mesh)]


def batch_size(tree) -> int:
    """The env count of a batched Data (or a batched tensor)."""
    return int((tree if torch.is_tensor(tree) else tree.qpos).shape[0])


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    return concat_batch([tree], device)


def consume(shards: Sequence[Data]) -> torch.Tensor:
    """The consumer: [mean qpos over every env of every shard, mean time], on
    the first shard's device (the JAX package's replicated psum / nenv)."""
    dev = shards[0].qpos.device
    total = sum(torch.cat([s.qpos.sum(0), s.time.sum().reshape(1)]).to(dev) for s in shards)
    return total / sum(batch_size(s) for s in shards)


def sharded_step_fn(m: Model, mesh: Sequence[torch.device], with_consumer: bool = True,
                    plan=None):
    """fn(shards) -> (shards, consumed): one step of every shard on its
    device (ops/forward.step with `plan`, make_plan(m) by default), and the
    consumer (zeros(1) without it)."""
    models = replicate_model(m, mesh)
    plans = step_plans(models, plan)

    def run(shards):
        shards = [fwd.step(mm, d, p) for mm, p, d in zip(models, plans, shards)]
        consumed = (consume(shards) if with_consumer
                    else shards[0].qpos.new_zeros(1))
        return shards, consumed
    return run


def scan_steps_fn(m: Model, mesh: Sequence[torch.device], nsub: int, plan=None):
    """fn(shards) -> shards after nsub steps of each (bench.py's shape)."""
    models = replicate_model(m, mesh)
    plans = step_plans(models, plan)

    def run(shards):
        out = []
        for mm, p, d in zip(models, plans, shards):
            for _ in range(nsub):
                d = fwd.step(mm, d, p)
            out.append(d)
        return out
    return run


def step_plans(models: Sequence[Model], plan) -> list:
    """A step plan for each device's model: `plan` where one is given (a
    GeneralPlan needs nothing of the device), else make_plan once a model."""
    if plan is not None:
        return [plan] * len(models)
    made: Dict[int, object] = {}
    for mm in models:
        if id(mm) not in made:
            made[id(mm)] = fwd.make_plan(mm)
    return [made[id(mm)] for mm in models]
