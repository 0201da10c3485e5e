"""SENSORS (BASELINE config 3's scene) through the port, against the JAX
package: sites, the sensor stages, the hooks and the sensors plugin.

Inputs are seeded numpy states handed to both packages (the port's Data is
carried across with tests/test_torch_general._to_port); on the CPU the
port's K1 and K2 calls run their plain versions. One JAX model is loaded
per dtype (module-scope caches).

- compile: 3 sites and 11 sensors (28 data) with the JAX package's
  addresses, dims, objects and cutoffs, every field equal to
  model_from_numpy of the JAX compile; 8 contact slots, 24 rows, the
  general route with K2;
- float64 forward of 8 envs in floor contact against jax.vmap(forward):
  site frames and the position- and velocity-stage sensordata at 1e-12,
  the accelerometer, force and torque at 1e-6 (tests/test_torch_humanoid.py
  holds qacc there: another Newton on the same rows); rays of the
  rangefinder that hit and that miss;
- ray_local against the JAX function on seeded rays, plane (finite and
  infinite), sphere, capsule, box, cylinder and ellipsoid, and the rays
  against a hull's triangles and a height field (sensor_impl._ray_geom,
  in a world of that one geom), at 1e-12;
- SENSORS with a cylinder under the probe that collides with nothing
  (ROADMAP C11's world): the rangefinder meets it; 1 float64 step
  against jax.vmap(fwd.step), sensordata at 1e-12, qpos and qvel at 1e-9;
- one float32 fwd.step against jax.vmap(fwd.step) at
  tests/test_torch_general.py's tolerances, sensordata at qvel's;
- the plugin's noise arithmetic: apply_noise fed the normals the JAX
  plugin draws from its keys equals the JAX plugin's noisy readings at
  1e-12 (cutoff scaling and the quaternion sensor included);
- plugin and server semantics (tests/test_plugins.py:168-210,
  tests/test_server.py:240-252) on the CPU: noise statistics, eval mode,
  ground truth tracking the state, models kept across reset, rejected
  models, seeding; the hooks' places in the step; the sensor-disable
  flag; unported sensor types raise.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.models import worlds as jworlds
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import sensor_impl as jsensor_impl
from mujoco_ros_pkgs_tpu.plugins.sensors import SensorsPlugin as JSensorsPlugin

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import GeomType, SensorType
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.msgs import SensorNoiseModel
from mujoco_ros_pkgs_tpu_torch.ops import efc, narrowphase, sensor_impl, step_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin, apply_noise, quat_adrs
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _to_port
from tests.torch_problems import SENSORS_NOISE, SENSORS_POS_VEL, sensors_states
from tests.torch_jax import jax_load

NENV = 8
# the acceleration stage's sensors
_ACC = ("acc", "frc", "trq")


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """(JAX model, port model) of SENSORS in float64 or float32."""
    jdt, pdt = {"f64": (None, None), "f32": (jnp.float32, torch.float32)}[dtype]
    return (jax_load(jworlds.SENSORS, dtype=jdt),
            mjcf.load_model_from_string(worlds.SENSORS, dtype=pdt))


def _jax_batch(jm, qpos, qvel, dtype):
    d1 = jfwd.make_data(jm, dtype=dtype)
    d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (qpos.shape[0],) + x.shape),
                               d1)
    return d.replace(qpos=jnp.asarray(qpos, dtype), qvel=jnp.asarray(qvel, dtype))


def _sensor(pm, data, name):
    i = pm.sensor(name)
    adr = pm.sensor_adr[i]
    return np.asarray(data)[:, adr:adr + pm.sensor_dim[i]]


def test_sensors_compile_as_jax():
    """3 sites, 11 sensors of 28 data; the sensor columns equal the JAX
    compile's exactly and every field the converted JAX model's; 8 slots
    of elliptic condim 3 (24 rows) that K2 takes, on the general route."""
    assert worlds.SENSORS == jworlds.SENSORS, "the port's copy of SENSORS drifted"
    jm, pm = _models("f64")
    assert (pm.nv, pm.nsite, pm.nsensor, pm.nsensordata) == (7, 3, 11, 28)
    for name in ("sensor_adr", "sensor_dim", "sensor_objtype", "sensor_objid",
                 "sensor_type", "sensor_reftype", "sensor_refid", "site_bodyid",
                 "sensor_names", "site_names"):
        assert getattr(pm, name) == tuple(getattr(jm, name)), name
    np.testing.assert_array_equal(pm.sensor_cutoff.numpy(), np.asarray(jm.sensor_cutoff))
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    assert len(narrowphase.slot_meta(pm)[0]) == 8 and efc.row_layout(pm)["nrow"] == 24
    assert fwd.make_plan(pm) == fwd.GeneralPlan() and not step_tpu.supports(pm)


def test_forward_matches_jax_float64():
    """forward of 8 seeded envs (the probe in floor contact in most) against
    jax.vmap(forward) in float64: site frames and the position- and
    velocity-stage sensors at 1e-12; accelerometer, force and torque, which
    read qacc, at 1e-6 (qacc itself too)."""
    jm, pm = _models("f64")
    qpos, qvel = sensors_states(NENV, seed=1)
    jd = _jax_batch(jm, qpos, qvel, jnp.float64)
    pd = fwd.forward(pm, _to_port(jd))
    jd = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
    for field in ("site_xpos", "site_xmat"):
        np.testing.assert_allclose(getattr(pd, field).numpy(), np.asarray(getattr(jd, field)),
                                   rtol=0, atol=1e-12, err_msg=field)
    for names, tol in ((SENSORS_POS_VEL, 1e-12), (_ACC, 1e-6)):
        for name in names:
            np.testing.assert_allclose(_sensor(pm, pd.sensordata, name),
                                       _sensor(pm, jd.sensordata, name),
                                       rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(pd.qacc.numpy(), np.asarray(jd.qacc), rtol=1e-6, atol=1e-6)
    rng = _sensor(pm, pd.sensordata, "range")[:, 0]
    assert (rng == -1).any() and (rng > 0).any(), rng
    assert int((pd.contact.dist < pd.contact.includemargin).sum()) > 0
    assert float(np.abs(_sensor(pm, pd.sensordata, "frc")).max()) > 0


_RAY_GEOMS = {"plane": (GeomType.PLANE, (0.8, 0.6, 1.0)),
              "plane_infinite": (GeomType.PLANE, (0.0, 0.0, 1.0)),
              "sphere": (GeomType.SPHERE, (0.4, 0.0, 0.0)),
              "capsule": (GeomType.CAPSULE, (0.2, 0.5, 0.0)),
              "box": (GeomType.BOX, (0.3, 0.5, 0.2)),
              "cylinder": (GeomType.CYLINDER, (0.3, 0.5, 0.0)),
              "ellipsoid": (GeomType.ELLIPSOID, (0.4, 0.3, 0.6)),
              "mesh": (GeomType.MESH, None),
              "hfield": (GeomType.HFIELD, None)}
# the one-geom worlds of the rays that read the model: a 12-point hull and
# a 6 x 5 height field, 1 m across
_RAY_WORLDS = {
    "mesh": """<mujoco><asset><mesh name="m" vertex="{}"/></asset>
      <worldbody><geom type="mesh" mesh="m"/></worldbody></mujoco>""".format(" ".join(
        f"{x:.6g}" for x in (np.random.default_rng(3).normal(size=(12, 3)) * 0.4).ravel())),
    "hfield": """<mujoco><asset><hfield name="h" nrow="6" ncol="5" size="0.9 0.7 0.4 0.2"
      elevation="{}"/></asset><worldbody><geom type="hfield" hfield="h"/></worldbody>
      </mujoco>""".format(" ".join(
        f"{x:.6g}" for x in np.random.default_rng(4).uniform(size=30)))}


@pytest.mark.parametrize("name", sorted(_RAY_GEOMS))
def test_ray_local_matches_jax(name):
    """ray_local on 256 seeded rays from origins around the geom in random
    directions, against the JAX function, float64, at 1e-12 (a miss is
    +inf on both sides); some hit and some miss. A mesh or a height field
    takes _ray_geom on a world of that geom alone (the JAX function
    unjitted: it reads the hull's vertices with np.asarray)."""
    gt, size = _RAY_GEOMS[name]
    rng = np.random.default_rng(int(gt) + 7)
    t = rng.uniform(-1.2, 1.2, size=(256, 3))
    v = rng.normal(size=(256, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if name in _RAY_WORLDS:
        pm = mjcf.load_model_from_string(_RAY_WORLDS[name])
        jm = jax_load(_RAY_WORLDS[name])
        got = sensor_impl._ray_geom(pm, 0, torch.from_numpy(t), torch.from_numpy(v)).numpy()
        jd = jfwd.make_data(jm).replace(geom_xpos=jnp.zeros((1, 3)),
                                        geom_xmat=jnp.eye(3)[None])
        want = np.asarray(jax.vmap(lambda a, b: jsensor_impl._ray_geom(jm, jd, 0, a, b))(
            jnp.asarray(t), jnp.asarray(v)))
    else:
        got = sensor_impl.ray_local(int(gt), torch.tensor(size, dtype=torch.float64),
                                    torch.from_numpy(t), torch.from_numpy(v)).numpy()
        want = np.asarray(jax.vmap(lambda a, b: jsensor_impl.ray_local(
            int(gt), jnp.asarray(size), a, b))(jnp.asarray(t), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    hit = np.isfinite(got)
    assert hit.any() and not hit.all(), hit.mean()


# ROADMAP C11's world: SENSORS with a cylinder under the probe that
# collides with nothing, which only the rangefinder sees
SENSORS_POST = worlds.SENSORS.replace(
    '<geom name="ground" type="plane" size="5 5 1"/>',
    '<geom name="ground" type="plane" size="5 5 1"/>\n    <geom name="post" type="cylinder" '
    'pos="0 0 0.1" size="0.3 0.1" contype="0" conaffinity="0"/>')


def test_rangefinder_on_a_cylinder_steps_as_jax():
    """SENSORS_POST (ROADMAP C11): the cylinder adds no collision pair; one
    float64 fwd.step against jax.vmap(fwd.step) from sensors_states: the
    position- and velocity-stage sensordata at 1e-12 (the rangefinder
    meets the post's cap), the acceleration stage's at 1e-6 (another
    Newton on the same rows, as test_forward_matches_jax_float64 holds
    them), qpos and qvel at 1e-9."""
    assert SENSORS_POST != worlds.SENSORS
    pm = mjcf.load_model_from_string(SENSORS_POST)
    jm = jax_load(SENSORS_POST)
    post = pm.geom("post")
    assert pm.geom_type[post] == int(GeomType.CYLINDER)
    assert len(pm.collision_pairs) == 3 and all(post not in p for p in pm.collision_pairs)
    qpos, qvel = sensors_states(NENV, seed=3)
    jd = _jax_batch(jm, qpos, qvel, jnp.float64)
    pd = fwd.step(pm, _to_port(jd))
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    for names, tol in ((SENSORS_POS_VEL, 1e-12), (_ACC, 1e-6)):
        for name in names:
            np.testing.assert_allclose(_sensor(pm, pd.sensordata, name),
                                       _sensor(pm, jd.sensordata, name),
                                       rtol=tol, atol=tol, err_msg=name)
    for field in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(pd, field).numpy(), np.asarray(getattr(jd, field)),
                                   rtol=1e-9, atol=1e-9, err_msg=field)
    rng = _sensor(pm, pd.sensordata, "range")[:, 0]
    assert ((rng > 0) & (rng < 0.3)).any(), rng


def test_step_matches_jax_float32():
    """One float32 fwd.step with sensors against jax.vmap(fwd.step), whose
    solve on the CPU is `_solve_jnp` (another Newton on the same rows; the
    port's is K2's plain version): qpos rtol 1e-5 / atol 1e-6, qvel and
    qacc rtol / atol 1e-4 (tests/test_torch_general.py's tolerances), every
    sensor at qvel's."""
    jm, pm = _models("f32")
    qpos, qvel = sensors_states(NENV, seed=2)
    jd = _jax_batch(jm, qpos, qvel, jnp.float32)
    pd = _to_port(jd)
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    with pytest.warns(UserWarning, match="truncated"):
        pd = fwd.step(pm, pd)
    for field, rtol, atol in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4),
                              ("qacc", 1e-4, 1e-4), ("sensordata", 1e-4, 1e-4)):
        np.testing.assert_allclose(getattr(pd, field).numpy(),
                                   np.asarray(getattr(jd, field)), rtol=rtol, atol=atol,
                                   err_msg=f"SENSORS {field} 1 step")
    assert int((pd.contact.dist < pd.contact.includemargin).sum()) > 0
    assert torch.isfinite(pd.sensordata).all()


def test_noise_arithmetic_matches_jax():
    """apply_noise, fed the N(0, 1) draws jax.random.split /
    jax.random.normal make from each env's key, equals the JAX plugin's
    last_stage readings at 1e-12 in float64: additive noise on the three
    bench models and on ajp, the RPY perturbation on probe_quat, cutoff
    scaling on the magnetometer and the torque sensor. The port's
    last_stage equals apply_noise on its generator's draws."""
    xml = (worlds.SENSORS.replace('<magnetometer name="mag" site="imu"/>',
                                  '<magnetometer name="mag" site="imu" cutoff="0.25"/>')
           .replace('<torque name="trq" site="ft"/>',
                    '<torque name="trq" site="ft" cutoff="3"/>'))
    jm, pm = jax_load(xml), mjcf.load_model_from_string(xml)
    models = list(SENSORS_NOISE) + [
        SensorNoiseModel("ajp", [0.05], [0.01], 0x1),
        SensorNoiseModel("probe_quat", [0.01, -0.02, 0.0], [0.05, 0.1, 0.2], 0x7)]
    rng = np.random.default_rng(4)
    sd = rng.normal(size=(NENV, pm.nsensordata))
    qadr = pm.sensor_adr[pm.sensor("probe_quat")]
    q = rng.normal(size=(NENV, 4))
    sd[:, qadr:qadr + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)

    jp = JSensorsPlugin()
    jd1 = jfwd.make_data(jm)
    jp.load(jm, jd1)
    assert jp.register_noise_models(models) == 0
    jps = jp.init_state(jm, 1)
    jd = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (NENV,) + x.shape), jd1)
    jd = jd.replace(sensordata=jnp.asarray(sd),
                    rng=jax.random.split(jax.random.PRNGKey(11), NENV))
    _, jout = jax.vmap(lambda d: jp.last_stage(jm, d, jps))(jd)
    normal = jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[1], (jm.nsensordata,),
                                                  dtype=jnp.float64))(jd.rng)

    pp = SensorsPlugin()
    pp.load(pm, fwd.make_data(pm, NENV))
    assert pp.register_noise_models(models) == 0
    ps = pp.init_state(pm, NENV)
    for key in ("mean", "std", "enabled"):
        np.testing.assert_array_equal(ps[key][0].numpy(), np.asarray(jps[key]), err_msg=key)
    gt = torch.from_numpy(sd) * pp._scale
    np.testing.assert_allclose(gt.numpy(), np.asarray(jout["gt"]), rtol=0, atol=1e-12)
    assert quat_adrs(pm) == (qadr,)
    noisy = apply_noise(gt, torch.from_numpy(np.array(normal)), ps["mean"], ps["std"],
                        ps["enabled"], quat_adrs(pm))
    np.testing.assert_allclose(noisy.numpy(), np.asarray(jout["noisy"]), rtol=0, atol=1e-12)
    assert float((noisy - gt)[:, qadr:qadr + 4].abs().min()) > 0

    d = fwd.make_data(pm, NENV).replace(sensordata=torch.from_numpy(sd))
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    _, out = pp.last_stage(pm, d, ps, gens[0])
    draws = torch.randn((NENV, pm.nsensordata), generator=gens[1], dtype=torch.float64)
    want = apply_noise(gt, draws, ps["mean"], ps["std"], ps["enabled"], quat_adrs(pm))
    assert torch.equal(out["noisy"], want) and torch.equal(out["gt"], gt)


def _server(nenv=1, **kw):
    plugin = SensorsPlugin(kw.pop("config", None))
    return MujocoServer(worlds.SENSORS, nenv=nenv, device="cpu", unpause=False,
                        plugins=[plugin], **kw), plugin


def test_sensor_noise_statistics():
    """Noise validation as mujoco_sensors_test.cpp:281-394 does it, over a
    batch: ajp with mean 0.05 and std 0.01, 256 envs x 20 steps; the mean
    and variance of noisy - GT within the reference's tolerances (0.02,
    1e-4), and bench_config3's acc model within 4 sigma / sqrt(N) of 0 and
    5% of its std."""
    srv, _ = _server(256)
    assert srv.register_noise_models(SENSORS_NOISE).success
    models = [SensorNoiseModel(sensor_name="ajp", mean=np.array([0.05]),
                               std=np.array([0.01]), set_flag=0x01)]
    assert srv.register_noise_models(models).success
    i, _ = srv._plugin_of(SensorsPlugin)
    m = srv.m
    ajp = m.sensor_adr[m.sensor("ajp")]
    diffs, acc = [], []
    for _ in range(20):
        assert srv.step(1).success
        ps = srv.pstates[i]
        delta = (ps["noisy"] - ps["gt"]).double()
        diffs.append(delta[:, ajp])
        acc.append(delta[:, :3].flatten())
    diffs, acc = torch.cat(diffs).numpy(), torch.cat(acc).numpy()
    assert abs(diffs.mean() - 0.05) < 0.02
    assert abs(diffs.var() - 0.01 ** 2) < 1e-4
    assert abs(acc.mean()) < 4 * 0.01 / np.sqrt(acc.size), acc.mean()
    assert abs(acc.std() / 0.01 - 1) < 0.05, acc.std()
    noisy, gt = srv.sensor_outputs(env_id=5)
    assert noisy.shape == gt.shape == (28,) and np.isfinite(noisy).all()


def test_sensor_gt_suppressed_in_eval_mode():
    srv, plugin = _server(2, config={"eval_mode": True})
    assert plugin.eval_mode
    srv.step(1)
    noisy, gt = srv.sensor_outputs()
    assert noisy is not None and np.isfinite(noisy).all()
    assert gt is None     # no _GT topic in eval mode (plugin.cpp:64-68)


def test_sensor_values_track_state():
    """After 10 steps the framepos reading is the probe's xpos and jointvel
    the hinge's qvel, exactly; range is -1 or positive."""
    srv, _ = _server(3)
    srv.step(10)
    m, d = srv.m, srv.d
    for env in range(3):
        _, gt = srv.sensor_outputs(env)
        adr = m.sensor_adr[m.sensor("probe_pos")]
        np.testing.assert_array_equal(gt[adr:adr + 3], d.xpos[env, m.body("probe")].numpy())
        adr = m.sensor_adr[m.sensor("ajv")]
        assert gt[adr] == float(d.qvel[env, m.jnt_dofadr[m.jnt_names.index("aj")]])
        rng = gt[m.sensor_adr[m.sensor("range")]]
        assert rng == -1 or rng > 0


@pytest.mark.parametrize("env_id", [-1, 3])
def test_sensor_outputs_rejects_bad_env_id(env_id):
    """An env id outside the batch raises IndexError, as get_body_state's
    does, rather than reading another env's sensors."""
    srv, _ = _server(3)
    with pytest.raises(IndexError, match="out of range"):
        srv.sensor_outputs(env_id)


def test_reset_keeps_registered_noise_models_and_reseeds():
    """Registered models persist across reset (plugin members in the
    reference), the state is rebuilt, the generator re-seeded: the same
    steps after reset give the same noisy readings; another seed differs."""
    srv, _ = _server(2, seed=3)
    nm = SensorNoiseModel(sensor_name="ajp", mean=[0.5], std=[0.1], set_flag=1)
    assert srv.register_noise_models([nm]).success
    srv.step(2)
    first = srv.sensor_outputs(1)[0]
    assert srv.reset().success
    i, _ = srv._plugin_of(SensorsPlugin)
    adr = srv.m.sensor_adr[srv.m.sensor("ajp")]
    assert float(srv.pstates[i]["mean"][0, adr]) == 0.5
    assert float(srv.pstates[i]["noisy"].abs().max()) == 0.0
    srv.step(2)
    np.testing.assert_array_equal(srv.sensor_outputs(1)[0], first)
    other, _ = _server(2, seed=4)
    assert other.register_noise_models([nm]).success
    other.step(2)
    assert other.sensor_outputs(1)[0][adr] != first[adr]


def test_unknown_sensor_rejected_and_plugin_services():
    """An unknown sensor's model is counted as rejected and the others are
    kept; without the plugin the services answer that it is missing;
    reload registers the plugin on the new model."""
    srv, plugin = _server(1)
    res = srv.register_noise_models([SensorNoiseModel("nope", [1.0], [0.0], 1),
                                     SensorNoiseModel("ajp", [1.0], [0.0], 1)])
    assert not res.success and res.status_message == "1 models rejected"
    i, _ = srv._plugin_of(SensorsPlugin)
    assert float(srv.pstates[i]["enabled"][0, srv.m.sensor_adr[srv.m.sensor("ajp")]]) == 1.0
    assert srv.reload(worlds.BOXES).success
    assert plugin.loaded and srv._plugin_of(SensorsPlugin)[1] is plugin
    assert srv.pstates[0]["noisy"].shape == (1, 0)
    bare = MujocoServer(worlds.SENSORS, nenv=1, device="cpu", unpause=False)
    assert not bare.register_noise_models(list(SENSORS_NOISE)).success
    assert bare.sensor_outputs() == (None, None)


class _Counter(MujocoPlugin):
    """Counts its control and passive calls per env; the passive hook
    pushes the hinge with 0.5 N m, the control hook reads the jointvel
    sensor the velocity stage wrote before it."""

    def init_state(self, m, nenv):
        z = torch.zeros(nenv, dtype=m.qpos0.dtype, device=m.device)
        return {"control": z, "passive": z.clone(), "ajv": z.clone()}

    def passive(self, m, d, ps):
        qfrc = d.qfrc_passive.clone()
        qfrc[:, 6] += 0.5
        return d.replace(qfrc_passive=qfrc), dict(ps, passive=ps["passive"] + 1)

    def control(self, m, d, ps):
        adr = m.sensor_adr[m.sensor("ajv")]
        return d, dict(ps, control=ps["control"] + 1, ajv=d.sensordata[:, adr])


def test_hooks_run_in_their_places():
    """forward with stateful hooks: the passive hook's torque reaches qacc
    as the same qfrc_applied does, the control hook sees the velocity
    stage's sensors, and the state threads through; (d, hstate) back."""
    _, pm = _models("f64")
    qpos, qvel = sensors_states(2, seed=6)
    d = fwd.make_data(pm, 2).replace(qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel))
    p = _Counter()
    st = p.init_state(pm, 2)
    out, st = fwd.forward(pm, d, lambda m, dd, s: p.control(m, dd, s),
                          lambda m, dd, s: p.passive(m, dd, s), hstate=st)
    qfrc = torch.zeros(2, pm.nv, dtype=torch.float64)
    qfrc[:, 6] = 0.5
    ref = fwd.forward(pm, d.replace(qfrc_applied=qfrc))
    np.testing.assert_allclose(out.qacc.numpy(), ref.qacc.numpy(), rtol=1e-12, atol=1e-12)
    assert st["control"].tolist() == st["passive"].tolist() == [1.0, 1.0]
    assert torch.equal(st["ajv"], torch.from_numpy(qvel[:, 6]))


def test_plugin_hooks_force_the_general_route(monkeypatch):
    """A server with a plugin whose hooks are composed steps BOXES on the
    general route (the fused kernel takes no hooks), threads the batched
    state through every step and rebuilds it on reset."""
    called = []
    monkeypatch.setattr(step_tpu, "step", lambda *a, **k: called.append(1))
    srv = MujocoServer(worlds.BOXES, nenv=2, device="cpu", unpause=False,
                       plugins=[_CounterNoSensor()])
    assert isinstance(srv._plan, step_tpu.Plan)
    srv.step(5)
    assert not called
    assert srv.pstates[0]["n"].tolist() == [5.0, 5.0]
    srv.reset()
    assert float(srv.pstates[0]["n"].abs().max()) == 0.0


class _CounterNoSensor(MujocoPlugin):
    def init_state(self, m, nenv):
        return {"n": torch.zeros(nenv, dtype=m.qpos0.dtype)}

    def control(self, m, d, ps):
        return d, {"n": ps["n"] + 1.0}


# the three types the port did not compute when this test was written; it
# computes all 36 now (tests/test_torch_sensors_more.py holds their values)
_UNPORTED = {
    "tendonpos": ('<tendon><fixed name="t"><joint joint="j" coef="0.5"/></fixed></tendon>'
                  '<sensor><tendonpos tendon="t"/></sensor>'),
    "subtreecom": '<sensor><subtreecom body="b"/></sensor>',
    "touch": '<sensor><touch site="s"/></sensor>',
}


@pytest.mark.parametrize("tag", sorted(_UNPORTED))
def test_unported_sensor_types_raise(tag):
    """Each sensor type compiles as the JAX package compiles it (every
    field of the model equal, the tendon's object type too), and
    make_plan takes it on the general route."""
    xml = ('<mujoco><worldbody><body name="b"><joint name="j"/><site name="s"/>'
           f'<geom type="sphere" size="0.1"/></body></worldbody>{_UNPORTED[tag]}</mujoco>')
    pm = mjcf.load_model_from_string(xml)
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(
        jax_load(xml))))
    assert pm.sensor_type == (int(SensorType[tag.upper()]),)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()


def test_sensor_disable_flag_skips_the_stages():
    """<flag sensor="disable"/> (DisableBit.SENSOR): the three stages leave
    sensordata as it was, and the step is otherwise the same."""
    xml = worlds.SENSORS.replace('cone="elliptic"/>',
                                 'cone="elliptic"><flag sensor="disable"/></option>')
    off = mjcf.load_model_from_string(xml)
    _, on = _models("f64")
    qpos, qvel = sensors_states(2, seed=8)

    def run(m):
        d = fwd.make_data(m, 2).replace(qpos=torch.from_numpy(qpos),
                                        qvel=torch.from_numpy(qvel))
        return fwd.forward(m, d)
    d_off, d_on = run(off), run(on)
    assert float(d_off.sensordata.abs().max()) == 0.0
    assert float(d_on.sensordata.abs().max()) > 0.0
    assert torch.equal(d_off.qacc, d_on.qacc)
