"""The torch port's parallel/ modules in one process, the native state codec
and the launcher's --f32 and --profile-dir.

- parallel/mesh.py over eight CPU devices (the JAX package's tests use eight
  virtual ones): the shards' steps and consumer against the unsplit step;
- make_host_env_mesh folding eight devices into 2 x 4, and a server whose
  batch is split into two host rows (mesh_hosts) against one batch;
- the noise draws of 1, 2 and 4 rank slices against one draw;
- HostCoordinator's single-process passthrough;
- the port's native blob against the JAX package's codec, byte for byte; a
  flipped byte refused; a "PYFB" checkpoint of an earlier version loaded; a
  checkpoint refused while the batch is split over ranks;
- the launcher's --f32 and --profile-dir.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu import native as jnative
from mujoco_ros_pkgs_tpu.server import checkpoint as jcheckpoint

from mujoco_ros_pkgs_tpu_torch import native
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.parallel import mesh, multihost as mh
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer, checkpoint, launch
from mujoco_ros_pkgs_tpu_torch.utils import rng
from tests.torch_problems import SENSORS_MOTOR, fused_states


def _boxes(nenv, seed=3):
    m = mjcf.load_model_from_string(worlds.BOXES).to("cpu", torch.float64)
    qpos, qvel = fused_states(nenv, seed)
    d = fwd.make_data(m, nenv)
    return m, d.replace(qpos=torch.from_numpy(qpos).double(),
                        qvel=torch.from_numpy(qvel).double())


def test_mesh_over_eight_devices_equals_the_unsplit_step():
    """BOXES in contact at 16 envs: shard_batch over 8 CPU devices, 3 steps of
    sharded_step_fn and of scan_steps_fn, the shards joined, equal the
    unsplit batch's steps bit for bit; the consumer is the mean within
    1e-12."""
    m, d = _boxes(16)
    devices = mesh.make_mesh(devices=["cpu"] * 8)
    shards = mesh.shard_batch(d, devices)
    assert len(shards) == 8 and all(mesh.batch_size(s) == 2 for s in shards)
    step = mesh.sharded_step_fn(m, devices)
    whole = d
    for _ in range(3):
        shards, consumed = step(shards)
        whole = fwd.step(m, whole)
    joined = mesh.concat_batch(shards)
    for f in ("qpos", "qvel", "qacc", "time"):
        assert torch.equal(getattr(joined, f), getattr(whole, f)), f
    want = torch.cat([whole.qpos.mean(0), whole.time.mean().reshape(1)])
    torch.testing.assert_close(consumed, want, rtol=0, atol=1e-12)
    scanned = mesh.scan_steps_fn(m, devices, 3)(mesh.shard_batch(d, devices))
    assert torch.equal(mesh.concat_batch(scanned).qpos, whole.qpos)
    assert mesh.sharded_step_fn(m, devices, with_consumer=False)(shards)[1].shape == (1,)


def test_host_env_mesh_folds_eight_devices():
    grid = mh.make_host_env_mesh(n_hosts=2, devices=["cpu"] * 8)
    assert grid.axis_names == ("host", "env") and grid.devices.shape == (2, 4)
    assert grid.size == 8 and len(grid.local_devices) == 8
    with pytest.raises(ValueError):
        mh.make_host_env_mesh(n_hosts=3, devices=["cpu"] * 8)


def test_server_host_rows_equal_one_batch():
    """A distributed server in one process with two host rows (mesh_hosts)
    steps each row on its own; with the sensors plugin and control noise
    its state equals a plain server's after the same calls."""
    kw = dict(nenv=4, device="cpu", dtype=torch.float64, ctrl_noise_std=0.3, seed=2)
    split = MujocoServer(SENSORS_MOTOR, distributed=True, mesh_hosts=2, **kw)
    plain = MujocoServer(SENSORS_MOTOR, **kw)
    assert split.mesh.devices.shape == (2, 1) and split._rows == (0, 4)
    for srv in (split, plain):
        assert srv.set_ctrl([0.5], env_id=3).success and srv.step(6).success
    for f in ("qpos", "qvel", "ctrl", "time"):
        assert torch.equal(getattr(split.d, f), getattr(plain.d, f)), f
    with pytest.raises(ValueError, match="not divisible"):
        MujocoServer(SENSORS_MOTOR, nenv=3, device="cpu", distributed=True, mesh_hosts=2)


@pytest.mark.parametrize("nslice", [1, 2, 4])
def test_noise_does_not_depend_on_the_rank_count(nslice):
    """Each slice's generator (env_rng) draws its rows of the one-process
    draw, draw after draw."""
    nenv, seed = 16, 11
    plain = torch.Generator()
    plain.manual_seed(seed)
    gens = [mh.env_rng(seed, nenv, k * nenv // nslice, (k + 1) * nenv // nslice)
            for k in range(nslice)]
    for shape in ((3,), (1,), (5,)):
        want = torch.randn((nenv, *shape), generator=plain, dtype=torch.float64)
        got = torch.cat([rng.randn((nenv // nslice, *shape), g, torch.float64, "cpu")
                         for g in gens])
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        rng.randn((3, 1), gens[0], torch.float64, "cpu")


def test_coordinator_single_process_passthrough():
    coord = mh.HostCoordinator()
    assert coord.next_command(mh.CMD_STEP_N, 7.0) == (mh.CMD_STEP_N, 7.0)
    assert coord.agree(123.0)
    coord.barrier()
    assert mh.broadcast_obj(("step", (3,), {})) == ("step", (3,), {})
    assert mh.gather_to_host(torch.ones(2, 3)).shape == (2, 3)


def _arrays():
    r = np.random.default_rng(0)
    return [np.ascontiguousarray(a) for a in (
        r.normal(size=(5, 7)), r.normal(size=(5, 3)).astype(np.float32),
        r.uniform(size=(5, 2)) > 0.5, np.arange(6, dtype=np.int64), np.zeros((5, 0)),
        r.integers(0, 255, size=(40000,), dtype=np.uint8))]


def test_native_blob_equals_the_jax_codec(tmp_path, monkeypatch):
    """native.pack's blob is the JAX package's native codec's, byte for byte,
    and unpacks to the same arrays. The JAX codec is built from its source
    into tmp_path (its loader builds next to the source, where another test
    process may be building it at the same time)."""
    shutil.copy(Path(jnative._HERE) / "statecodec.cpp", tmp_path)
    monkeypatch.setattr(jnative, "_HERE", str(tmp_path))
    monkeypatch.setattr(jnative, "_LIBS", {})
    arrays = _arrays()
    blob = native.pack(arrays)
    jblob = jcheckpoint._pack(arrays)
    assert jblob[:4] == native.MAGIC, "the JAX package's codec did not build"
    assert blob == jblob
    specs = [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrays]
    for got, want in zip(native.unpack(blob, specs), arrays):
        np.testing.assert_array_equal(got, want)


def test_flipped_byte_is_refused(tmp_path):
    """A blob with one byte flipped fails its CRC32: ValueError, from the
    codec and from checkpoint.load."""
    arrays = _arrays()
    specs = [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrays]
    blob = bytearray(native.pack(arrays))
    blob[40] ^= 0x10
    with pytest.raises(ValueError, match="CRC32"):
        native.unpack(bytes(blob), specs)
    srv = MujocoServer(SENSORS_MOTOR, nenv=2, device="cpu")
    path = str(tmp_path / "ck")
    checkpoint.save(srv, path)
    raw = bytearray((tmp_path / "ck.bin").read_bytes())
    assert bytes(raw[:4]) == native.MAGIC
    raw[-1] ^= 0x01
    (tmp_path / "ck.bin").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC32"):
        checkpoint.load(srv, path)


def test_pyfb_checkpoint_still_loads(tmp_path, monkeypatch):
    """A checkpoint whose blob is the numpy format (PYFB) of earlier
    versions loads: the state comes back; a split batch has no checkpoint."""
    srv = MujocoServer(SENSORS_MOTOR, nenv=3, device="cpu", ctrl_noise_std=0.2, seed=1)
    assert srv.step(5).success
    q0 = srv.d.qpos.clone()
    path = str(tmp_path / "ck")
    checkpoint.save(srv, path)
    manifest = json.loads((tmp_path / "ck.json").read_text())
    arrays = native.unpack((tmp_path / "ck.bin").read_bytes(), manifest["arrays"])
    pyfb = b"PYFB" + b"".join(a.nbytes.to_bytes(8, "little") + a.tobytes() for a in arrays)
    (tmp_path / "ck.bin").write_bytes(pyfb)
    assert srv.step(7).success and not torch.equal(srv.d.qpos, q0)
    checkpoint.load(srv, path)
    assert torch.equal(srv.d.qpos, q0)
    srv._dist = True
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="ranks"):
        checkpoint.save(srv, path)


def test_launcher_f32_and_profile_dir(tmp_path, capsys):
    """--f32 serves float32 on the CPU (float64 without it); --profile-dir
    writes a Chrome trace that holds the physics loop's torch ops."""
    model = tmp_path / "boxes.xml"
    model.write_text(worlds.BOXES)
    prof = tmp_path / "prof"
    assert launch.main(["--modelfile", str(model), "--nenv", "2", "--num-steps", "3",
                        "--device", "cpu", "--f32", "--profile-dir", str(prof)]) == 0
    err = capsys.readouterr().err
    assert "dtype float32 on cpu" in err and f"profile: {prof}" in err
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert launch.main(["--modelfile", str(model), "--nenv", "2", "--num-steps", "3",
                        "--device", "cpu"]) == 0
    assert "dtype float64 on cpu" in capsys.readouterr().err
