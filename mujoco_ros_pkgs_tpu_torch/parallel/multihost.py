"""Multi-process distribution over torch.distributed: one process per rank,
the env batch split by rank, a collective consumer and a control plane that
process 0 originates.

Counterpart of mujoco_ros_pkgs_tpu/parallel/multihost.py (its names kept, so
that each counterpart can be found). The reference is one process with one
physics thread and ROS as its only boundary (SURVEY.md section 2.6); BASELINE
config 5 asks for a contact-rich scene sharded over 2+ hosts feeding a
sharded consumer through collectives:

- `initialize()` joins the process group (gloo, over TCP, with a short
  timeout so that a dead rank fails its peers instead of hanging them);
  every collective runs on CPU tensors, the rank's device tensors moved
  with an explicit `.cpu()`. NCCL refuses two ranks on one card, and the
  card's machine has one, so gloo carries every run;
- `make_host_env_mesh()` is the ('host', 'env') grid: a row a rank, its
  columns the devices the rank steps on (one: `cuda:{rank % count}`); in
  one process `n_hosts` folds a device list into rows, as the JAX function
  folds virtual devices;
- `make_global_batch()` builds only this process's rows of the global
  batch, `init_fn(d_local, global_idx)` setting them from global env ids;
  `env_rng` is a generator whose draws are the global batch's, cut to the
  rank's rows, so the noise does not depend on the rank count;
- `shardmap_step_fn()` steps each rank's rows on its device and forms the
  consumer (global mean qpos and mean time) by all_reduce of the local sums;
  `shardmap_hooked_step()` is its twin with plugin states and the server's
  hooked step;
- `HostCoordinator`, `broadcast_obj` and `from_owner` are the control
  plane: process 0 originates, every rank observes the same sequence.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.parallel import mesh as mesh_mod
from mujoco_ros_pkgs_tpu_torch.utils.rng import RowGenerator

# every collective of a run waits at most this long (a rank that died or hung
# fails the others' next collective instead of stopping them for good)
DEFAULT_TIMEOUT_S = 300.0
_LOOPBACK = ("127.0.0.1", "localhost", "::1", "[::1]")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (once; later calls return). The arguments
    default to the MRT_COORDINATOR (host:port), MRT_NUM_PROCESSES and
    MRT_PROCESS_ID environment variables; with no coordinator the run is a
    single process and nothing happens. A loopback coordinator binds gloo to
    the loopback interface (GLOO_SOCKET_IFNAME=lo unless set), so that the
    rendezvous does not depend on resolving the machine's hostname."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("MRT_COORDINATOR")
    if coordinator_address is None:
        return
    if num_processes is None and "MRT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MRT_NUM_PROCESSES"])
    if process_id is None and "MRT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MRT_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("a distributed run needs its number of processes and this "
                         "process's id (arguments or MRT_NUM_PROCESSES / MRT_PROCESS_ID)")
    host, sep, port = coordinator_address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"coordinator address '{coordinator_address}' is not host:port")
    if host in _LOOPBACK:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://{host}:{port}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, once every process has come to it (the
    launcher's last act)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device rank `rank` (this process's by default) steps on: for CUDA
    the card `rank % count` (both ranks on cuda:0 on a one-card machine),
    else `device` as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


@dataclass(frozen=True)
class Mesh:
    """The ('host', 'env') grid of devices: `devices[h, e]`."""
    devices: np.ndarray
    axis_names = ("host", "env")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices this process steps on: its row in a multi-process run,
        every device of the grid in one process."""
        rows = self.devices[process_index()] if process_count() > 1 else self.devices
        return list(np.asarray(rows).reshape(-1))


def make_host_env_mesh(n_hosts: Optional[int] = None, devices=None,
                       device="cuda") -> Mesh:
    """The ('host', 'env') grid. Several processes: a row a rank, each of one
    device, `rank_device(device)` of that rank. One process: `devices` (or
    every CUDA device, the CPU where there is none) folded into `n_hosts`
    rows (1 by default)."""
    nproc = process_count()
    if devices is None and nproc > 1:
        grid = [[rank_device(device, r)] for r in range(nproc)]
    else:
        devs = mesh_mod.make_mesh(devices=devices)
        n_hosts = n_hosts or 1
        if len(devs) % n_hosts:
            raise ValueError(f"{len(devs)} devices not divisible by n_hosts={n_hosts}")
        grid = [devs[i:i + len(devs) // n_hosts]
                for i in range(0, len(devs), len(devs) // n_hosts)]
    arr = np.empty((len(grid), len(grid[0])), dtype=object)
    for h, row in enumerate(grid):
        for e, dev in enumerate(row):
            arr[h, e] = dev
    return Mesh(arr)


def replicate_model(m: Model, mesh: Mesh) -> List[Model]:
    """The model on each device this process steps on."""
    return mesh_mod.replicate_model(m, mesh.local_devices)


def local_rows(nenv: int) -> tuple:
    """(lo, hi): this process's rows of a global batch of nenv envs."""
    nproc = process_count()
    if nenv % nproc:
        raise ValueError(f"nenv={nenv} not divisible by {nproc} processes")
    per = nenv // nproc
    return process_index() * per, (process_index() + 1) * per


def env_rng(seed: int, nenv: int, lo: int = 0, hi: Optional[int] = None,
            device="cpu") -> RowGenerator:
    """A generator for rows [lo, hi) of a batch of nenv, seeded with seed:
    its draws (utils/rng.randn) are the single-process batch's rows, however
    many ranks share the batch."""
    gen = RowGenerator(device, lo, nenv if hi is None else hi, nenv)
    gen.manual_seed(seed)
    return gen


def make_global_batch(m: Model, nenv: int, mesh: Mesh,
                      init_fn: Optional[Callable] = None) -> Data:
    """This process's rows of a global batch of nenv envs at qpos0, on its
    first device (every process builds only its own rows);
    `init_fn(d_local, global_idx) -> d_local` sets them from the global env
    ids (np.ndarray), so that the state does not depend on the process
    count."""
    if nenv % mesh.size:
        raise ValueError(f"nenv={nenv} not divisible by mesh size {mesh.size}")
    lo, hi = local_rows(nenv)
    d = fwd.make_data(m.to(mesh.local_devices[0]), hi - lo)
    if init_fn is not None:
        d = init_fn(d, np.arange(lo, hi))
    return d


def _split_local(tree, mesh: Mesh, nenv: int) -> list:
    """The local batch (nenv envs) cut over this process's devices, each
    piece on its own."""
    local = mesh.local_devices
    if len(local) == 1:
        return [tree]
    return mesh_mod.shard_batch(tree, local, nenv)


def shardmap_hooked_step(mesh: Mesh, nsub: int, one_batch: Callable, device=None):
    """fn(d, ps) -> (d, ps): `one_batch(d, ps) -> (d, ps)` (a hooked step of
    a batch and its plugin states, on the device its piece lies on) run nsub
    times on each of this process's devices' shares of the local batch, the
    shares then joined on `device` (the first local device by default)."""

    def run(d, ps):
        out_d, out_ps = [], []
        n = mesh_mod.batch_size(d)
        for dd, pp in zip(_split_local(d, mesh, n), _split_local(ps, mesh, n)):
            for _ in range(nsub):
                dd, pp = one_batch(dd, pp)
            out_d.append(dd)
            out_ps.append(pp)
        if len(out_d) == 1:
            return out_d[0], out_ps[0]
        dev = device if device is not None else mesh.local_devices[0]
        return mesh_mod.concat_batch(out_d, dev), mesh_mod.concat_batch(out_ps, dev)
    return run


def shardmap_step_fn(m: Model, mesh: Mesh, nsub: int = 1, with_consumer: bool = True,
                     control_hook=None, passive_hook=None, plan=None):
    """fn(d_local) -> (d_local, consumed): nsub steps of this process's rows
    (ops/forward.step with `plan`, make_plan(m) by default, and the hooks),
    and the consumer: [mean qpos, mean time] over the global batch, the
    local sums in float64 all_reduced over the processes (zeros(1) without
    it), on the batch's device, identical on every rank."""
    models = replicate_model(m, mesh)
    on = {mm.device: (mm, p) for mm, p in zip(models, mesh_mod.step_plans(models, plan))}

    def one_batch(d, ps):
        mm, p = on[d.qpos.device]
        return fwd.step(mm, d, p, control_hook, passive_hook), ps
    stepped = shardmap_hooked_step(mesh, nsub, one_batch)

    def run(d):
        d, _ = stepped(d, ())
        if not with_consumer:
            return d, d.qpos.new_zeros(1)
        local = torch.cat([d.qpos.double().sum(0), d.time.double().sum().reshape(1)]).cpu()
        total = torch.cat([local, torch.tensor([float(d.qpos.shape[0])],
                                               dtype=torch.float64)])
        if process_count() > 1:
            dist.all_reduce(total)
        return d, (total[:-1] / total[-1]).to(d.qpos.device)
    return run


# ---------------------------------------------------------------------------
# the control plane: process 0 originates
# ---------------------------------------------------------------------------

# command opcodes broadcast from process 0 (the ROS services of
# callbacks.cpp:49-92 as one broadcast)
CMD_NOOP = 0
CMD_PAUSE = 1
CMD_RESUME = 2
CMD_STEP_N = 3
CMD_RESET = 4
CMD_SHUTDOWN = 5


class HostCoordinator:
    """Process 0's commands observed by every rank: each rank calls
    `next_command(its proposal)` at the same step boundary and gets process
    0's; `barrier()` keeps any rank from running ahead (the reference's
    /clock discipline, mujoco_env.cpp:699-714). A single process passes its
    own proposal through."""

    def next_command(self, cmd: int, arg: float = 0.0) -> tuple:
        if process_count() <= 1:
            return cmd, arg
        t = torch.tensor([float(cmd), float(arg)], dtype=torch.float64)
        dist.broadcast(t, src=0)
        return int(t[0]), float(t[1])

    def agree(self, value) -> bool:
        """True when every process proposes the same value (of one shape)."""
        if process_count() <= 1:
            return True
        mine = torch.as_tensor(np.asarray(value, dtype=np.float64)).reshape(-1)
        every = [torch.empty_like(mine) for _ in range(process_count())]
        dist.all_gather(every, mine)
        return all(torch.equal(t, every[0]) for t in every)

    def barrier(self, name: str = "step"):
        """Every rank waits for the others (`name` labels the call site)."""
        if process_count() > 1:
            dist.barrier()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t on the CPU, contiguous, bool as uint8 (what every gloo op carries)."""
    t = t.detach().cpu().contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def gather_to_host(t_local: torch.Tensor) -> np.ndarray:
    """The global batch of a batched tensor, as numpy on every process
    (all_gather of the processes' rows, in rank order)."""
    if process_count() <= 1:
        return t_local.detach().cpu().numpy()
    mine = _wire(t_local)
    every = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(every, mine)
    out = torch.cat(every)
    return (out.bool() if t_local.dtype == torch.bool else out).numpy()


def local_shard_np(t_local: torch.Tensor) -> np.ndarray:
    """This process's rows as numpy (no collective)."""
    return t_local.detach().cpu().numpy()


def scatter_from_host(np_arr: np.ndarray, mesh: Optional[Mesh] = None, dtype=None,
                      device=None) -> torch.Tensor:
    """This process's rows of a global numpy array that every process passes
    whole, as a tensor on `device` (the mesh's first local device, else the
    CPU): gather_to_host's inverse."""
    if device is None:
        device = mesh.local_devices[0] if mesh is not None else "cpu"
    lo, hi = local_rows(len(np_arr))
    return torch.as_tensor(np.ascontiguousarray(np_arr[lo:hi])).to(device=device, dtype=dtype)


def broadcast_obj(obj=None):
    """A picklable object from process 0 to every process (what the ROS graph
    gave the reference for free: every node sees the same service call)."""
    if process_count() <= 1:
        return obj
    box = [obj if process_index() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def from_owner(fn: Callable[[int], object], env_id: int, nenv: int):
    """fn(local index of env_id) computed on the process that holds the env
    and broadcast to every process (CPU objects: a row, an env's Data)."""
    if process_count() <= 1:
        return fn(env_id)
    per = nenv // process_count()
    owner = env_id // per
    box = [fn(env_id - owner * per) if process_index() == owner else None]
    dist.broadcast_object_list(box, src=owner)
    return box[0]


def any_(flag: bool) -> bool:
    """True when any process's flag is."""
    if process_count() <= 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t[0])

