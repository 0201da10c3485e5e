"""MujocoServer for the torch port: a batch of envs behind the service surface.

Counterpart of mujoco_ros_pkgs_tpu/server/server.py. The batch lives on one
device, the card unless the caller asks for another; each step runs the
whole batch through ops/forward.step: one launch of the fused step kernel
for a single free body, or the general path (with the Cholesky and Newton
kernels) for other models, whenever a plugin is loaded, and while a wrench
or a generalized force is applied (the fused kernel reads neither).

The control plane mirrors the reference's services and Step action
(callbacks.cpp:49-92) and the JAX server's additions:

- loading: reload with rollback, the loading state, initial joint states
  applied at load and on every reset (load_initial_joint_states);
- stepping: `step` (rejected while the physics loop runs unpaused), the
  Step action with feedback per chunk and preemption (`step_action`), the
  physics-loop thread paced at `realtime_factor` (`start_physics_loop`,
  `set_speed`, `measured_slowdown`), the sim-time stream
  (`subscribe_clock`), pause, reset, shutdown;
- state: control (`set_ctrl`, and Ornstein-Uhlenbeck control noise inside
  every step), joint positions (`set_qpos`), body state (`set_body_state`,
  poses in static TF frames), wrenches (`apply_body_wrench`), equality
  parameters, the plugins' services (noise models, sensor outputs, mocap
  targets), a float parameter store;
- model edits: gravity, geom properties (friction, size, the body's mass,
  the type, which rebuilds the pair table and the contact buffers),
  physics options (`set_physics_properties`; a cone change rebuilds the
  row buffer), a body's mass with its derived constants. Each edit is made
  on the served model's float64 master copy, which is cast to the batch's
  device and dtype and planned anew (ops/forward.make_plan), so that the
  fused route's packed parameters follow it. An edit the port cannot step
  (another integrator, fluid) fails and leaves model, plan and batch as
  they were;
- eval mode: every mutating call checks the admin hash (callbacks.cpp:
  213-223), and the constructor refuses eval mode without one;
- the lock discipline: one lock guards the batch, the model and the
  plugin states, and while the physics thread runs a write to `d`, `m` or
  `pstates` without it raises LockDisciplineError.

Plugins (plugins/) hook into every step with their batched state; their
randomness, and the control noise's, comes from the server's
torch.Generator on the batch's device, seeded by `seed` and re-seeded by
`reset`. Checkpoints: server/checkpoint.py.

Not ported yet: rendering and cameras, keyframes, saving the model, the
distributed plane and the native state codec.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core import assemble, constants, mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import (
    ConeType, EqType, GeomType, IntegratorType, JointType, Model, SolverType,
)
from mujoco_ros_pkgs_tpu_torch.msgs import (
    BodyState, EqualityConstraintParameters, GeomProperties, MocapState, Pose,
    ServiceResult, SolverParameters, StateUint, StepFeedback, StepGoal, StepResult,
    Twist,
)
from mujoco_ros_pkgs_tpu_torch.ops import broadphase, efc, narrowphase, solver
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin, PluginRegistry
from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin
from mujoco_ros_pkgs_tpu_torch.utils.log import get_logger

# operational status (get_loading_request_state, callbacks.cpp:72-87)
STATUS_RUNNING = 0
STATUS_LOADING = 1

CHUNK = 64          # substeps of `step` and of the unbound physics loop per chunk
ACTION_CHUNK = 16   # substeps of the Step action per feedback
# geom types a geom may be set to: those the port compiles (core/mjcf.py)
SETTABLE_GEOM_TYPES = (GeomType.PLANE, GeomType.SPHERE, GeomType.CAPSULE, GeomType.BOX)


class AdminHashError(PermissionError):
    pass


class LockDisciplineError(AssertionError):
    """A guarded state attribute was written without holding the server lock
    while the physics thread runs (the reference guards the same state with
    physics_thread_mutex_, mujoco_env.h:90,155)."""


class _ServerLock:
    """The server's re-entrant lock, handed over to waiting threads: a
    stepping thread holds it over a chunk and, between two steps, lets a
    service that waits for it go first (CPython's locks are not fair: a
    thread that releases a lock and at once takes it again usually wins,
    and the services would wait for the loop to stop)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._is_owned = self._lock._is_owned
        self._count = threading.Lock()
        self._waiting = 0

    def acquire(self):
        if self._lock.acquire(blocking=False):
            return True
        with self._count:
            self._waiting += 1
        try:
            return self._lock.acquire()
        finally:
            with self._count:
                self._waiting -= 1

    def release(self):
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def yield_to_waiters(self, timeout: float = 0.05):
        """Called without the lock: wait (at most `timeout` s) while threads
        wait for it, so that they take it first."""
        if not self._waiting:
            return
        deadline = _time.perf_counter() + timeout
        while self._waiting and _time.perf_counter() < deadline:
            _time.sleep(0)


class MujocoServer:
    """Batched simulation server.

    Args:
      model: MJCF path or XML string.
      nenv: number of lockstep env instances.
      device: where the batch lives and steps ("cuda" by default; "cpu"
        runs the plain torch versions of the kernels).
      dtype: the batch's float dtype. The card's kernels take float32 only,
        so float64 is refused on CUDA; it serves the CPU parity tests.
      eval_mode, admin_hash: every mutating call must give the hash.
      unpause: start running (the physics loop advances a running server).
      num_steps: the physics loop stops after this many steps (-1 = never).
      realtime: the loop's pace as a fraction of real time (-1 = unbound).
      initial_joint_states, initial_joint_velocities: {joint name: values},
        applied at load and on every reset.
      plugins: MujocoPlugin instances, loaded on every model the server
        installs (a plugin whose load fails is kept but not called).
      ctrl_noise_std, ctrl_noise_rate: Ornstein-Uhlenbeck noise on ctrl in
        every step (std 0 = off; rate: the noise's time constant in seconds).
      seed: seed of the generator the plugins and the control noise draw from.
      pair_topk: broadphase compaction capacity of every model the server
        compiles (types.Model.pair_topk; 0 = every pair of the table runs).
      con_topk: active-contact compaction capacity (types.Model.con_topk;
        0 = the solver takes every contact slot).
    """

    # attributes whose writes need the lock while the physics thread runs
    _GUARDED = frozenset({"d", "m", "pstates"})

    def __init__(self, model: str, nenv: int = 1, *, device="cuda",
                 dtype=torch.float32, eval_mode: bool = False, admin_hash: str = "",
                 unpause: bool = False, num_steps: int = -1, realtime: float = -1.0,
                 initial_joint_states: Optional[dict] = None,
                 initial_joint_velocities: Optional[dict] = None,
                 plugins: Sequence[MujocoPlugin] = (), ctrl_noise_std: float = 0.0,
                 ctrl_noise_rate: float = 0.0, seed: int = 0, pair_topk: int = 0,
                 con_topk: int = 0):
        if eval_mode and not admin_hash:
            # mujoco_env.cpp:92-105: eval mode requires an admin hash
            raise AdminHashError("eval mode requires an admin hash")
        self.nenv = int(nenv)
        if self.nenv < 1:
            raise ValueError(f"nenv must be >= 1, got {nenv}")
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda" and dtype != torch.float32:
            raise ValueError(f"the card's kernels take float32, not {dtype}")
        self.eval_mode = bool(eval_mode)
        self._admin_hash = admin_hash
        self.pair_topk = int(pair_topk)
        self.con_topk = int(con_topk)
        self.paused = not unpause
        self.num_steps_until_exit = int(num_steps)
        self.realtime_factor = float(realtime)
        self.measured_slowdown = 0.0
        self._speed_changed = False
        self._exit_request = False
        self._step_preempt = False
        self._step_thread: Optional[threading.Thread] = None
        self._physics_thread: Optional[threading.Thread] = None
        # set when the physics thread dies on an exception (the CLI then
        # exits 1 instead of serving a stopped clock)
        self.physics_error: Optional[BaseException] = None
        self._clock_subs: List[Callable[[float], None]] = []
        self._float_params: Dict[str, float] = {}
        self._static_tf: Dict[str, tuple] = {}
        self._init_js = dict(initial_joint_states or {})
        self._init_jv = dict(initial_joint_velocities or {})
        self.ctrl_noise_std = float(ctrl_noise_std)
        self.ctrl_noise_rate = float(ctrl_noise_rate)
        self._plugins = list(plugins)
        self._seed = int(seed)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._seed)
        self._lock = _ServerLock()
        self._log = get_logger("server")
        self._status = STATUS_LOADING
        self._load_error = ""
        self._install(*self._compile(model), model)

    def __setattr__(self, name, value):
        # the guarded attributes are first written by _install, after
        # _lock and _physics_thread exist
        if (name in MujocoServer._GUARDED and self._physics_thread is not None
                and not self._lock._is_owned()):
            raise LockDisciplineError(
                f"write to MujocoServer.{name} while the physics loop is running, "
                f"without holding the server lock: wrap it in `with server._lock:`")
        object.__setattr__(self, name, value)

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    def _compile(self, source: str):
        """Compile a model: (the float64 master on the CPU, the served model,
        its step plan); raises on a bad or unsupported model without
        touching the served state."""
        kw = dict(pair_topk=self.pair_topk, con_topk=self.con_topk)
        if "<" in source:
            m64 = mjcf.load_model_from_string(source, **kw)
        else:
            m64 = mjcf.load_model(source, **kw)
        return (m64, *self._serve(m64))

    def _serve(self, m64: Model):
        """The served model (m64 on the batch's device and dtype) and its
        plan; raises NotImplementedError for a model the port cannot step."""
        m = m64.to(self.device, self.dtype)
        return m, fwd.make_plan(m)

    def _install(self, m64: Model, m: Model, plan, source: str):
        self._m64, self.m, self._plan = m64, m, plan
        self._dt = float(m64.opt.timestep)
        self._model_source = source
        self.d = fwd.make_data(m, self.nenv)
        self._apply_initial_joint_states()
        self.registry = PluginRegistry()
        for p in self._plugins:
            self.registry.register(p, m, self.d)
        self.pstates = self.registry.init_states(m, self.nenv)
        self._hooks = (self.registry.control_hook(), self.registry.passive_hook(),
                       self.registry.last_stage_hook())
        self._applied = False
        self._needs_forward = False
        self._status = STATUS_RUNNING
        self._load_error = ""
        quarantined = [p.__class__.__name__ for p in self.registry.plugins
                       if not p.loaded]
        self._log.info("model '%s' loaded: nenv=%d nbody=%d nv=%d plugins=%d on %s%s",
                       m.name or "<inline>", self.nenv, m.nbody, m.nv,
                       len(self.registry.cb_ready), self.device,
                       f" QUARANTINED={quarantined}" if quarantined else "")

    def _apply_initial_joint_states(self):
        """loadInitialJointStates (mujoco_env.cpp:266-389): joint positions
        and velocities by name, in every env."""
        m = self.m
        for names, field, adr_of, size_of in (
                (self._init_js, "qpos", m.jnt_qposadr, JointType.nq),
                (self._init_jv, "qvel", m.jnt_dofadr, JointType.nv)):
            if not names:
                continue
            arr = getattr(self.d, field).clone()
            for name, vals in names.items():
                j = m.joint(name)
                v = np.atleast_1d(np.asarray(vals, dtype=np.float64))
                v = v[:size_of(JointType(m.jnt_type[j]))]
                arr[:, adr_of[j]:adr_of[j] + len(v)] = torch.as_tensor(v, dtype=arr.dtype)
            self.d = self.d.replace(**{field: arr})

    def reload(self, model: str = "", admin_hash: str = "") -> ServiceResult:
        """Reload the current or a new model, with the server's pair_topk and
        con_topk; on failure the old model keeps serving
        (initModelFromQueue, mujoco_env.cpp:851-869)."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        source = model or self._model_source
        with self._lock:
            self._status = STATUS_LOADING
            try:
                compiled = self._compile(source)
            except (ValueError, NotImplementedError, SyntaxError, OSError) as exc:
                # ET.ParseError is a SyntaxError
                self._load_error = f"{type(exc).__name__}: {exc}"
                self._status = STATUS_RUNNING
                self._log.error("reload failed (old model kept): %s", self._load_error)
                return ServiceResult(False, self._load_error)
            self._install(*compiled, source)
        return ServiceResult(True, "")

    def get_loading_request_state(self) -> StateUint:
        desc = {STATUS_RUNNING: "simulation ready",
                STATUS_LOADING: "loading in progress"}[self._status]
        return StateUint(self._status, desc)

    def load_initial_joint_states(self, positions: dict, velocities: dict,
                                  admin_hash: str = "") -> ServiceResult:
        """New initial joint states, applied now and on every reset."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        with self._lock:
            try:
                for name in (*positions, *velocities):
                    self.m.joint(name)
            except ValueError:
                return ServiceResult(False, f"no joint named '{name}'")
            self._init_js, self._init_jv = dict(positions), dict(velocities)
            self._apply_initial_joint_states()
            self._needs_forward = True
        return ServiceResult(True, "")

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def ctrl_noise_coefficients(self):
        """(rate, scale) of the control noise in one step:
        ctrl <- rate ctrl + scale N(0, 1), rate = exp(-dt / ctrl_noise_rate)
        (0 when the rate is 0), scale = std sqrt(1 - rate^2)
        (mujoco_env.cpp:469-481)."""
        rate = math.exp(-self._dt / self.ctrl_noise_rate) if self.ctrl_noise_rate > 0 else 0.0
        return rate, self.ctrl_noise_std * math.sqrt(max(1.0 - rate * rate, 0.0))

    def _substep(self):
        """One step of the batch, under the lock: the control noise, the
        step with the plugins' control and passive hooks inside, their last
        stage after it. With a wrench applied, a model on the fused route
        steps on the general route (the fused kernel reads no applied
        force)."""
        m, plan, d, ps = self.m, self._plan, self.d, self.pstates
        control, passive, last = self._hooks
        if self.ctrl_noise_std > 0 and m.nu:
            rate, scale = self.ctrl_noise_coefficients()
            noise = torch.randn(d.ctrl.shape, generator=self._generator,
                                dtype=d.ctrl.dtype, device=d.ctrl.device)
            d = d.replace(ctrl=rate * d.ctrl + scale * noise)
        if self._applied and isinstance(plan, step_tpu.Plan):
            plan = fwd.GeneralPlan()
        if control or passive:
            d, ps = fwd.step(m, d, plan, control, passive, hstate=ps)
        else:
            d = fwd.step(m, d, plan)
        if last:
            d, ps = last(m, d, ps, self._generator)
        # the caller holds the lock: no need for __setattr__'s check
        self.__dict__.update(d=d, pstates=ps)

    def _run(self, nsteps: int, until: Optional[Callable[[], bool]] = None) -> int:
        """Up to nsteps steps of the batch under the lock, handed to a
        waiting service between two steps (it waits for one step at most),
        stopping early once until() holds; returns the steps taken."""
        lock, k = self._lock, 0
        with lock:
            while k < nsteps and not (until is not None and until()):
                self._substep()
                k += 1
                if lock._waiting:
                    lock.release()
                    lock.yield_to_waiters()
                    lock.acquire()
        return k

    def step(self, nsteps: int = 1) -> StepResult:
        """Step the paused batch nsteps times (callbacks.cpp:94-129), in
        chunks of CHUNK substeps; rejected for nsteps <= 0 and while the
        physics loop runs unpaused."""
        if (not self.paused and self._physics_thread is not None) or nsteps <= 0:
            return StepResult(success=False)
        left = nsteps
        while left > 0:
            chunk = min(left, CHUNK)
            self._run(chunk)
            left -= chunk
        self._publish_clock()
        return StepResult(success=True)

    def step_action(self, goal: StepGoal, feedback_cb=None, done_cb=None) -> bool:
        """The Step action, without blocking: a thread steps goal.num_steps
        in chunks of ACTION_CHUNK, calling feedback_cb(StepFeedback) after
        each and done_cb(StepResult) at the end (success False when
        preempted by `preempt_step_action` or shutdown). Rejected (False)
        while the physics loop runs unpaused and for num_steps <= 0."""
        if (not self.paused and self._physics_thread is not None) or goal.num_steps <= 0:
            if done_cb:
                done_cb(StepResult(success=False))
            return False
        self._step_preempt = False

        def work():
            left, ok = goal.num_steps, True
            while left > 0:
                if self._step_preempt or self._exit_request:
                    ok = False
                    break
                left -= self._run(min(left, ACTION_CHUNK))
                self._publish_clock()
                if feedback_cb:
                    feedback_cb(StepFeedback(steps_left=left))
            if done_cb:
                done_cb(StepResult(success=ok))

        self._step_thread = threading.Thread(target=work, daemon=True)
        self._step_thread.start()
        return True

    def preempt_step_action(self, timeout: float = 60.0):
        """Stop the Step action before its next chunk and wait for it
        (not from inside its own callbacks, which run on its thread)."""
        self._step_preempt = True
        t = self._step_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)

    @property
    def sim_time(self) -> float:
        with self._lock:
            return float(self.d.time[0])

    def subscribe_clock(self, cb: Callable[[float], None]):
        """The sim-time stream (publishSimTime, mujoco_env.cpp:699-714): cb
        gets the sim time after every chunk."""
        self._clock_subs.append(cb)

    def _publish_clock(self):
        if self._clock_subs:
            t = self.sim_time
            for cb in self._clock_subs:
                cb(t)

    # ------------------------------------------------------------------
    # physics loop (paced background stepping)
    # ------------------------------------------------------------------

    def start_physics_loop(self):
        if self._physics_thread is not None:
            return
        self._exit_request = False
        self._physics_thread = threading.Thread(target=self._physics_loop, daemon=True)
        self._physics_thread.start()

    def stop_physics_loop(self, timeout: float = 60.0):
        self._exit_request = True
        t = self._physics_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)

    def _physics_loop(self):
        """The physics thread: a step that raises stops the loop and is kept
        in `physics_error` (the CLI exits 1), the control plane stays up."""
        try:
            self._physics_loop_inner()
        except Exception as exc:   # noqa: BLE001 - any step failure
            self.physics_error = exc
            self._log.error("physics loop died: %r", exc, exc_info=True)
        finally:
            self._physics_thread = None

    def _forward_batch(self):
        """mj_forward of the whole batch (no hooks, no integration): derived
        state after a service edited the state or the model."""
        self.d = fwd.forward(self.m, self.d)

    def _physics_loop_inner(self):
        """physicsLoop (mujoco_env.cpp:436-639): chunks of CHUNK substeps when
        unbound (cut short by a pause, a speed change or a stop), of one when
        paced at realtime_factor (sim time against the wall clock, the
        baseline reset on pause and on a speed change); while paused, a
        forward pass when a service left derived state stale; the clock
        after every chunk; stops at num_steps."""
        cpu_start = _time.perf_counter()
        sim_start = self.sim_time
        while not self._exit_request and self.num_steps_until_exit != 0:
            if self.paused or self._speed_changed:
                self._speed_changed = False
                cpu_start = _time.perf_counter()
                sim_start = self.sim_time
                if self.paused:
                    if self._needs_forward:
                        with self._lock:
                            self._forward_batch()
                            self._needs_forward = False
                    _time.sleep(0.001)
                    continue
            chunk = CHUNK if self.realtime_factor < 0 else 1
            if self.num_steps_until_exit > 0:
                chunk = min(chunk, self.num_steps_until_exit)
            done = self._run(chunk, until=lambda: (self._exit_request or self.paused
                                                   or self._speed_changed))
            if self.num_steps_until_exit > 0:
                self.num_steps_until_exit -= done
            self._publish_clock()
            elapsed_cpu = _time.perf_counter() - cpu_start
            elapsed_sim = self.sim_time - sim_start     # waits for the chunk
            if elapsed_cpu > 0:
                self.measured_slowdown = elapsed_sim / elapsed_cpu
            # ahead of the pace: wait, in slices of at most 0.1 s that end
            # early on a pause, a speed change or a stop
            ahead = (elapsed_sim / self.realtime_factor - elapsed_cpu
                     if self.realtime_factor > 0 else 0.0)
            while ahead > 0 and not (self._exit_request or self.paused
                                     or self._speed_changed):
                _time.sleep(min(ahead, 0.1))
                ahead = (elapsed_sim / self.realtime_factor
                         - (_time.perf_counter() - cpu_start))

    # ------------------------------------------------------------------
    # admin gating
    # ------------------------------------------------------------------

    def _check_hash(self, admin_hash: str) -> Optional[ServiceResult]:
        """Eval-mode gate on mutating calls (callbacks.cpp:213-223)."""
        if self.eval_mode and admin_hash != self._admin_hash:
            return ServiceResult(False, "invalid admin hash")
        return None

    # ------------------------------------------------------------------
    # run-state services
    # ------------------------------------------------------------------

    def set_pause(self, paused: bool, admin_hash: str = "") -> ServiceResult:
        err = self._check_hash(admin_hash)
        if err:
            return err
        with self._lock:
            self.paused = bool(paused)
        return ServiceResult(True, "")

    def set_speed(self, factor: float, admin_hash: str = "") -> ServiceResult:
        """The loop's pace as a fraction of real time (the viewer's speed
        slider, mujoco_env.h:236-239); factor <= 0: unbound."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        with self._lock:
            self.realtime_factor = float(factor) if factor > 0 else -1.0
            self._speed_changed = True
        return ServiceResult(True, "")

    def shutdown(self) -> ServiceResult:
        with self._lock:
            self._exit_request = True
        self.stop_physics_loop()
        return ServiceResult(True, "")

    def reset(self, admin_hash: str = "") -> ServiceResult:
        """mj_resetData of every env, the initial joint states and the
        plugins' reset (resetSim, mujoco_env.cpp:246-264): the equalities'
        activity goes back to eq_active0 (their parameters stay as last
        set), plugin state is rebuilt (noise models registered at run time
        are kept) and the generator re-seeded."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        with self._lock:
            self.d = fwd.make_data(self.m, self.nenv)
            self._apply_initial_joint_states()
            self.registry.reset_all(self.m, self.d)
            self.pstates = self.registry.init_states(self.m, self.nenv)
            self._generator.manual_seed(self._seed)
            self._applied = False
        return ServiceResult(True, "")

    def set_float(self, name: str, value: float, admin_hash: str = "") -> ServiceResult:
        """SetFloat (mujoco_ros_msgs): a named float parameter."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        with self._lock:
            self._float_params[name] = float(value)
        return ServiceResult(True, "")

    def get_float(self, name: str) -> Optional[float]:
        return self._float_params.get(name)

    # ------------------------------------------------------------------
    # state services
    # ------------------------------------------------------------------

    def _envs(self, env_id: Optional[int]):
        """The batch index of env_id (None: every env), or None if out of range."""
        if env_id is None:
            return slice(None)
        return env_id if 0 <= env_id < self.nenv else None

    def set_ctrl(self, values, env_id: Optional[int] = None,
                 admin_hash: str = "") -> ServiceResult:
        """Write the control vector (nu,) of every env (env_id None) or of
        one env, in place, into the batch's ctrl on its device; the next step
        reads it (the viewer's control sliders, viewer.cpp Sync)."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        vals = np.asarray(values, dtype=np.float64)
        if vals.shape != (self.m.nu,):
            return ServiceResult(False, f"ctrl needs shape ({self.m.nu},), got {vals.shape}")
        envs = self._envs(env_id)
        if envs is None:
            return ServiceResult(False, f"bad env_id {env_id}")
        with self._lock:
            ctrl = self.d.ctrl
            ctrl[envs] = torch.as_tensor(vals, dtype=ctrl.dtype).to(ctrl.device)
        return ServiceResult(True, "")

    def set_qpos(self, values, env_id: Optional[int] = None, zero_qvel: bool = False,
                 admin_hash: str = "") -> ServiceResult:
        """Write qpos (nq,) of every env or one (the viewer's joint
        sliders); zero_qvel stills them too."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        vals = np.asarray(values, dtype=np.float64)
        if vals.shape != (self.m.nq,):
            return ServiceResult(False, f"qpos needs shape ({self.m.nq},), got {vals.shape}")
        envs = self._envs(env_id)
        if envs is None:
            return ServiceResult(False, f"bad env_id {env_id}")
        with self._lock:
            qpos, qvel = self.d.qpos.clone(), self.d.qvel.clone()
            qpos[envs] = torch.as_tensor(vals, dtype=qpos.dtype).to(qpos.device)
            if zero_qvel:
                qvel[envs] = 0.0
            self.d = self.d.replace(qpos=qpos, qvel=qvel)
            self._needs_forward = True
        return ServiceResult(True, "")

    def _env_slice(self, env_id: int):
        """The batch's state of one env, as a batch of one (every tensor of
        Data and its contact set, sliced). Call under the lock."""
        e = slice(env_id, env_id + 1)

        def cut(obj):
            return obj.replace(**{f.name: getattr(obj, f.name)[e]
                                  for f in dataclasses.fields(obj)
                                  if torch.is_tensor(getattr(obj, f.name))})
        d = cut(self.d)
        return d.replace(contact=cut(d.contact))

    def get_solver_stats(self, env_id: int = 0) -> dict:
        """Solver and contact diagnostics of one env (the JAX server's
        get_solver_stats, the data behind the viewer's profiler figures):
        contact slots and active contacts, the deepest penetration, the
        largest row force, the constraint force's norm, the solver's row
        count and iteration limit, the loop's measured slowdown, a
        diagnostic re-solve's Newton trips, gradient norm and cost
        (ops/solver.solve_stats, outside the lock), and the overlapping
        pairs the broadphase compaction dropped (`broadphase_overflow`, 0
        without pair_topk)."""
        if not 0 <= env_id < self.nenv:
            raise IndexError(f"env_id {env_id} out of range [0, {self.nenv})")
        with self._lock:
            m, d1 = self.m, self._env_slice(env_id)
            sim_time = float(self.d.time[env_id])
        dist = d1.contact.dist[0].double().cpu().numpy()
        incm = d1.contact.includemargin[0].double().cpu().numpy()
        fc = d1.efc_force_contact[0].double().cpu().numpy()
        stats = {
            "ncon_capacity": int(dist.shape[0]),
            "ncon_active": int((dist < incm).sum()),
            "max_penetration": float(max(0.0, -dist.min()) if dist.size else 0.0),
            "efc_force_max": float(np.abs(fc).max()) if fc.size else 0.0,
            "qfrc_constraint_norm": float(d1.qfrc_constraint[0].double().norm()),
            "measured_slowdown": float(self.measured_slowdown),
            "sim_time": sim_time,
            "solver_iterations_limit": int(m.opt.iterations),
            "nefc": int(fc.shape[0]),
        }
        ss = solver.solve_stats(m, d1)
        stats.update(
            solver_iterations_realized=int(ss["iterations"][0]),
            solver_grad_norm=float(ss["grad_norm"][0]),
            solver_cost=float(ss["cost"][0]),
            broadphase_overflow=int(broadphase.candidate_overflow(m, d1)[0]))
        return stats

    def get_batch_state(self) -> dict:
        """numpy snapshot of the batch (qpos, qvel, time)."""
        with self._lock:
            return dict(qpos=self.d.qpos.cpu().numpy(),
                        qvel=self.d.qvel.cpu().numpy(),
                        time=self.d.time.cpu().numpy())

    def _free_jnt_of_body(self, b: int) -> Optional[int]:
        if self.m.body_jntnum[b] == 1:
            j = self.m.body_jntadr[b]
            if self.m.jnt_type[j] == int(JointType.FREE):
                return j
        return None

    def get_body_state(self, name: str, env_id: int = 0) -> BodyState:
        """Pose and world-frame twist of a free body in one env, read from
        qpos and qvel (no forward pass needed)."""
        m = self.m
        b = m.body(name)
        if not 0 <= env_id < self.nenv:
            raise IndexError(f"env_id {env_id} out of range [0, {self.nenv})")
        st = BodyState(name=name, env_id=env_id)
        st.mass = float(self._m64.body_mass[b])
        j = self._free_jnt_of_body(b)
        if j is not None:
            qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
            with self._lock:
                qpos = self.d.qpos[env_id].double().cpu()
                qvel = self.d.qvel[env_id].double().cpu()
            st.pose = Pose(qpos[qadr:qadr + 3].numpy().copy(),
                           qpos[qadr + 3:qadr + 7].numpy().copy())
            # free-joint angular velocity is body-local; report it in world
            w_world = mmath.rot_vec_quat(qvel[vadr + 3:vadr + 6],
                                         qpos[qadr + 3:qadr + 7])
            st.twist = Twist(qvel[vadr:vadr + 3].numpy().copy(), w_world.numpy())
        return st

    def set_body_state(self, state: BodyState, set_pose: bool = True,
                       set_twist: bool = True, set_mass: bool = False,
                       admin_hash: str = "") -> ServiceResult:
        """SetBodyState (callbacks.cpp:226-505): pose (in the world or a
        registered static frame, state.pose.frame_id) and twist (world
        frame) of a free body, in every env (state.env_id None) or one; a
        mass change re-derives the model's constants (mj_setConst,
        callbacks.cpp:244-258)."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        try:
            b = self.m.body(state.name)
        except ValueError:
            return ServiceResult(False, f"body '{state.name}' not found")
        envs = self._envs(state.env_id)
        if envs is None:
            return ServiceResult(False, f"bad env_id {state.env_id}")
        with self._lock:
            m = self.m
            if set_pose or set_twist:
                j = self._free_jnt_of_body(b)
                if j is None:
                    return ServiceResult(False, f"body '{state.name}' has no free joint")
                qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
                qpos, qvel = self.d.qpos.clone(), self.d.qvel.clone()
                env0 = 0 if state.env_id is None else state.env_id
                if set_pose:
                    quat = torch.as_tensor(np.asarray(state.pose.orientation, np.float64))
                    quat = quat / max(float(quat.norm()), 1e-15)
                    pos = torch.as_tensor(np.asarray(state.pose.position, np.float64))
                    fid = state.pose.frame_id or ""
                    if fid not in ("", "world"):
                        # the tf2 lookup the reference makes before applying a
                        # PoseStamped (callbacks.cpp:298-302)
                        fr = self._resolve_frame(fid)
                        if fr is None:
                            return ServiceResult(False, f"unknown TF frame '{fid}'")
                        fpos, fquat = (torch.as_tensor(a) for a in fr)
                        pos = fpos + mmath.rot_vec_quat(pos, fquat)
                        quat = mmath.quat_mul(fquat, quat)
                    qpos[envs, qadr:qadr + 3] = pos.to(qpos)
                    qpos[envs, qadr + 3:qadr + 7] = quat.to(qpos)
                if set_twist:
                    # world angular velocity -> the free joint's body-local dofs
                    q = qpos[env0, qadr + 3:qadr + 7].double().cpu()
                    w = torch.as_tensor(np.asarray(state.twist.angular, np.float64))
                    w_local = mmath.rot_vec_quat(w, mmath.quat_conj(q))
                    lin = torch.as_tensor(np.asarray(state.twist.linear, np.float64))
                    qvel[envs, vadr:vadr + 3] = lin.to(qvel)
                    qvel[envs, vadr + 3:vadr + 6] = w_local.to(qvel)
                self.d = self.d.replace(qpos=qpos, qvel=qvel)
                self._needs_forward = True
            if set_mass:
                mass = self._m64.body_mass.clone()
                mass[b] = float(state.mass)
                res = self._edit_model(constants.set_constants(
                    dataclasses.replace(self._m64, body_mass=mass)))
                if res is not None:
                    return res
        return ServiceResult(True, "")

    def apply_body_wrench(self, name: str, force=(0.0, 0.0, 0.0), torque=(0.0, 0.0, 0.0),
                          env_id: Optional[int] = None, admin_hash: str = "") -> ServiceResult:
        """A persistent external wrench on a body (world frame, at its
        center of mass; xfrc_applied, as the viewer's mouse perturbation
        writes it), in every env (env_id None) or one, until cleared."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        try:
            b = self.m.body(name)
        except ValueError:
            return ServiceResult(False, f"no body named '{name}'")
        envs = self._envs(env_id)
        if envs is None:
            return ServiceResult(False, f"bad env_id {env_id}")
        wrench = np.concatenate([np.asarray(force, np.float64), np.asarray(torque, np.float64)])
        with self._lock:
            xf = self.d.xfrc_applied.clone()
            xf[envs, b] = torch.as_tensor(wrench, dtype=xf.dtype).to(xf.device)
            self.d = self.d.replace(xfrc_applied=xf)
            self._applied = bool((xf != 0).any() or (self.d.qfrc_applied != 0).any())
        return ServiceResult(True, "")

    def clear_body_wrenches(self, admin_hash: str = "") -> ServiceResult:
        err = self._check_hash(admin_hash)
        if err:
            return err
        with self._lock:
            self.d = self.d.replace(xfrc_applied=torch.zeros_like(self.d.xfrc_applied))
            self._applied = bool((self.d.qfrc_applied != 0).any())
        return ServiceResult(True, "")

    # ------------------------------------------------------------------
    # static TF registry (registerStaticTransform, mujoco_env.cpp:178-195)
    # ------------------------------------------------------------------

    def register_static_transform(self, parent: str, child: str, pos=(0.0, 0.0, 0.0),
                                  quat=(1.0, 0.0, 0.0, 0.0)) -> None:
        """Register a static parent -> child transform (pos, wxyz quat)."""
        self._static_tf[child] = (parent, np.asarray(pos, dtype=np.float64),
                                  np.asarray(quat, dtype=np.float64))

    def _resolve_frame(self, frame_id: str):
        """World pose (pos, wxyz quat) of a named frame, chaining static
        transforms parent-ward to 'world'; None if unknown."""
        if frame_id in ("", "world"):
            return np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0])
        if frame_id not in self._static_tf:
            return None
        parent, pos, quat = self._static_tf[frame_id]
        base = self._resolve_frame(parent)
        if base is None:
            return None
        bpos, bquat = (torch.as_tensor(a) for a in base)
        wpos = bpos + mmath.rot_vec_quat(torch.as_tensor(pos), bquat)
        return wpos.numpy(), mmath.quat_mul(bquat, torch.as_tensor(quat)).numpy()

    # ------------------------------------------------------------------
    # model edits
    # ------------------------------------------------------------------

    def _edit_model(self, m64: Model, rebuild_contact: bool = False,
                    rebuild_rows: bool = False) -> Optional[ServiceResult]:
        """Serve m64, an edit of the float64 master: cast, planned anew, the
        batch's contact set (rebuild_contact) and row-force buffer
        (rebuild_rows, or when the row count changes) rebuilt empty. A model
        the port cannot step leaves everything as it was and returns the
        failure. Call under the lock."""
        try:
            m, plan = self._serve(m64)
        except (NotImplementedError, ValueError) as exc:
            return ServiceResult(False, f"{type(exc).__name__}: {exc}")
        d = self.d
        if rebuild_contact:
            d = d.replace(contact=narrowphase.empty_contact(m, self.nenv, d.qpos.dtype,
                                                            d.qpos.device))
        nefc = max(efc.row_layout(m)["nrow"], 1)
        if rebuild_rows or d.efc_force_contact.shape[1] != nefc:
            d = d.replace(efc_force_contact=d.qpos.new_zeros(self.nenv, nefc))
        self._m64, self.m, self._plan, self.d = m64, m, plan, d
        self._dt = float(m64.opt.timestep)
        self._needs_forward = True
        return None

    def get_gravity(self) -> np.ndarray:
        return self._m64.opt.gravity.numpy().copy()

    def set_gravity(self, gravity, admin_hash: str = "") -> ServiceResult:
        err = self._check_hash(admin_hash)
        if err:
            return err
        g = torch.as_tensor(np.asarray(gravity, dtype=np.float64).reshape(3))
        with self._lock:
            m64 = self._m64
            res = self._edit_model(dataclasses.replace(
                m64, opt=dataclasses.replace(m64.opt, gravity=g)))
        return res or ServiceResult(True, "")

    def get_geom_properties(self, name: str) -> GeomProperties:
        m = self._m64
        g = m.geom(name)
        fr, sz = m.geom_friction[g].tolist(), m.geom_size[g].tolist()
        return GeomProperties(
            name=name, type=m.geom_type[g], body_mass=float(m.body_mass[m.geom_bodyid[g]]),
            friction_slide=fr[0], friction_spin=fr[1], friction_roll=fr[2],
            size_0=sz[0], size_1=sz[1], size_2=sz[2])

    def set_geom_properties(self, props: GeomProperties, set_type: bool = False,
                            set_mass: bool = False, set_friction: bool = False,
                            set_size: bool = False, admin_hash: str = "") -> ServiceResult:
        """SetGeomProperties (callbacks.cpp:508-592): friction, size (and
        the bounding radius), the geom's body's mass, the type (the pair
        table and the batch's contact and row buffers rebuilt); the
        model's constants re-derived, the plugins told (on_geom_changed)."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        try:
            g = self.m.geom(props.name)
        except ValueError:
            return ServiceResult(False, f"geom '{props.name}' not found")
        with self._lock:
            m = self._m64
            upd = {}
            if set_friction:
                fr = m.geom_friction.clone()
                fr[g] = torch.tensor([props.friction_slide, props.friction_spin,
                                      props.friction_roll], dtype=fr.dtype)
                upd["geom_friction"] = fr
            if set_size:
                sz = m.geom_size.clone()
                sz[g] = torch.tensor([props.size_0, props.size_1, props.size_2],
                                     dtype=sz.dtype)
                upd["geom_size"] = sz
            if set_mass:
                bm = m.body_mass.clone()
                bm[m.geom_bodyid[g]] = float(props.body_mass)
                upd["body_mass"] = bm
            retype = set_type and int(props.type) != m.geom_type[g]
            if retype:
                if int(props.type) not in [int(t) for t in SETTABLE_GEOM_TYPES]:
                    return ServiceResult(False, f"geom type {int(props.type)} is not ported")
                gt = list(m.geom_type)
                gt[g] = int(props.type)
                upd["geom_type"] = tuple(gt)
            if not upd:
                return ServiceResult(True, "")
            newm = dataclasses.replace(m, **upd)
            if set_size or retype:
                rb = newm.geom_rbound.clone()
                rb[g] = mjcf._geom_rbound(newm.geom_type[g], newm.geom_size[g].numpy())
                newm = dataclasses.replace(newm, geom_rbound=rb)
            if retype:
                newm = assemble.rebuild_pair_table(newm)
            res = self._edit_model(constants.set_constants(newm), rebuild_contact=retype,
                                   rebuild_rows=retype)
            if res is not None:
                return res
            for p in self.registry.cb_ready:
                p.on_geom_changed(self.m, g)
        return ServiceResult(True, "")

    # physics options (the viewer Sync's mjModel.opt editing,
    # viewer.cpp:1552-1871, as a service)
    _OPT_ARRAY_FIELDS = ("timestep", "gravity", "wind", "magnetic", "density",
                         "viscosity", "impratio", "o_margin", "tolerance", "ls_tolerance")
    _OPT_STATIC_FIELDS = ("integrator", "cone", "solver", "iterations", "ls_iterations",
                          "disableflags")
    _OPT_ENUMS = {"integrator": IntegratorType, "cone": ConeType, "solver": SolverType}

    def get_physics_properties(self) -> dict:
        """The model's options as a plain dict (enums by name)."""
        o = self._m64.opt
        out = {f: getattr(o, f).tolist() for f in self._OPT_ARRAY_FIELDS}
        out.update({k: e(getattr(o, k)).name for k, e in self._OPT_ENUMS.items()},
                   iterations=int(o.iterations), ls_iterations=int(o.ls_iterations),
                   disableflags=int(o.disableflags))
        return out

    def set_physics_properties(self, props: dict, admin_hash: str = "") -> ServiceResult:
        """Edit the model's options on a running server: array fields
        (timestep, gravity, ...), enums by name or value (integrator, cone,
        solver) and integers (iterations, ls_iterations, disableflags). A
        cone change rebuilds the row-force buffer (pyramidal facets and
        elliptic blocks differ in rows). An option the port cannot step
        (an integrator other than Euler, CG or PGS, fluid) fails and leaves
        the model as it was."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        unknown = [k for k in props
                   if k not in self._OPT_ARRAY_FIELDS and k not in self._OPT_STATIC_FIELDS]
        if unknown:
            return ServiceResult(False, f"unknown option fields: {unknown}")
        with self._lock:
            o = self._m64.opt
            upd = {}
            try:
                for k, v in props.items():
                    if k in self._OPT_ARRAY_FIELDS:
                        cur = getattr(o, k)
                        upd[k] = torch.as_tensor(
                            np.asarray(v, dtype=np.float64).reshape(tuple(cur.shape)))
                    elif k in self._OPT_ENUMS:
                        e = self._OPT_ENUMS[k]
                        upd[k] = int(e[v.upper()] if isinstance(v, str) else e(int(v)))
                    else:
                        upd[k] = int(v)
            except (KeyError, ValueError) as exc:
                return ServiceResult(False, f"bad option value: {exc}")
            opt = dataclasses.replace(o, **upd)
            newm = dataclasses.replace(self._m64, opt=opt, has_fluid=bool(
                float(opt.density) > 0 or float(opt.viscosity) > 0
                or bool((opt.wind != 0).any())))
            res = self._edit_model(newm, rebuild_rows=opt.cone != o.cone)
            if res is not None:
                return res
            self._log.info("physics options updated: %s", sorted(props))
        return ServiceResult(True, "")

    # ------------------------------------------------------------------
    # equality constraints
    # ------------------------------------------------------------------

    def get_eq_constraint_parameters(self, name: str, env_id: int = 0
                                     ) -> EqualityConstraintParameters:
        """GetEqualityConstraintParameters: the model's parameters of the
        named equality and its activity in env env_id."""
        m = self._m64
        e = m.eq_names.index(name)
        data, solref, solimp = (t[e].numpy().copy() for t in (m.eq_data, m.eq_solref,
                                                               m.eq_solimp))
        with self._lock:
            active = bool(self.d.eq_active[env_id, e])
        p = EqualityConstraintParameters(
            name=name, type=m.eq_type[e], active=active,
            solverParameters=SolverParameters(
                dmin=solimp[0], dmax=solimp[1], width=solimp[2], midpoint=solimp[3],
                power=solimp[4], timeconst=solref[0], dampratio=solref[1]))
        if m.eq_type[e] in (int(EqType.CONNECT), int(EqType.WELD)):
            p.anchor = data[0:3].copy()
            p.element1 = m.body_names[m.eq_obj1id[e]]
            p.element2 = m.body_names[m.eq_obj2id[e]]
            if m.eq_type[e] == int(EqType.WELD):
                p.relpose = Pose(data[3:6].copy(), data[6:10].copy())
                p.torquescale = float(data[10])
        else:
            p.polycoef = data[0:5].copy()
            p.element1 = m.jnt_names[m.eq_obj1id[e]]
            p.element2 = m.jnt_names[m.eq_obj2id[e]] if m.eq_obj2id[e] >= 0 else ""
        return p

    def set_eq_constraint_parameters(self, p: EqualityConstraintParameters,
                                     admin_hash: str = "") -> ServiceResult:
        """SetEqualityConstraintParameters (callbacks.cpp:641-884): the
        equality's solver parameters and data (connect: anchor; weld:
        anchor, relpose with its quaternion normalised, torquescale; joint:
        polycoef) for every env; its activity in one env (p.env_id) or in
        all. The row layout does not change: an equality's rows are always
        present, gated by d.eq_active."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        m = self._m64
        if p.name not in m.eq_names:
            return ServiceResult(False, f"equality '{p.name}' not found")
        envs = self._envs(p.env_id)
        if envs is None:
            return ServiceResult(False, f"bad env_id {p.env_id}")
        e = m.eq_names.index(p.name)
        with self._lock:
            data, solref, solimp = (t.numpy().copy() for t in (m.eq_data, m.eq_solref,
                                                                m.eq_solimp))
            sp = p.solverParameters
            solimp[e] = [sp.dmin, sp.dmax, sp.width, sp.midpoint, sp.power]
            solref[e] = [sp.timeconst, sp.dampratio]
            if m.eq_type[e] == int(EqType.CONNECT):
                data[e, 0:3] = p.anchor
            elif m.eq_type[e] == int(EqType.WELD):
                q = np.asarray(p.relpose.orientation, dtype=np.float64)
                qn = np.linalg.norm(q)
                data[e, 0:3] = p.anchor
                data[e, 3:6] = p.relpose.position
                data[e, 6:10] = q / qn if qn > 1e-15 else [1.0, 0, 0, 0]
                data[e, 10] = p.torquescale
            else:
                data[e, 0:5] = p.polycoef
            res = self._edit_model(dataclasses.replace(
                m, eq_data=torch.from_numpy(data), eq_solref=torch.from_numpy(solref),
                eq_solimp=torch.from_numpy(solimp)))
            if res is not None:
                return res
            eq_active = self.d.eq_active.clone()
            eq_active[envs, e] = bool(p.active)
            self.d = self.d.replace(eq_active=eq_active)
        return ServiceResult(True, "")

    # ------------------------------------------------------------------
    # plugin-backed services
    # ------------------------------------------------------------------

    def _plugin_of(self, cls):
        for i, p in enumerate(self.registry.cb_ready):
            if isinstance(p, cls):
                return i, p
        return None, None

    def set_mocap_state(self, state: MocapState, admin_hash: str = "") -> ServiceResult:
        """mocap/set_mocap_state: the mocap plugin's targets of the named
        mocap bodies in every env (state.env_id None) or one; fails on a
        name that is not a mocap body (mocap_plugin.cpp:50-70)."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        i, p = self._plugin_of(MocapPlugin)
        if p is None:
            return ServiceResult(False, "no mocap plugin loaded")
        if self._envs(state.env_id) is None:
            return ServiceResult(False, f"bad env_id {state.env_id}")
        with self._lock:
            states = list(self.pstates)
            states[i], res = p.set_state(states[i], state)
            self.pstates = tuple(states)
        return res

    def register_noise_models(self, models, admin_hash: str = "") -> ServiceResult:
        """sensors/register_noise_models: the sensors plugin keeps the
        models of known sensors and every env's noise parameters follow;
        fails when a model names an unknown sensor (the others are kept)."""
        err = self._check_hash(admin_hash)
        if err:
            return err
        i, p = self._plugin_of(SensorsPlugin)
        if p is None:
            return ServiceResult(False, "no sensors plugin loaded")
        with self._lock:
            rejected = p.register_noise_models(models)
            ps = dict(self.pstates[i])
            for key, arr in zip(("mean", "std", "enabled"), p.noise_arrays(self.m)):
                ps[key] = arr.expand(self.nenv, -1).clone()
            states = list(self.pstates)
            states[i] = ps
            self.pstates = tuple(states)
        return ServiceResult(rejected == 0, f"{rejected} models rejected")

    def sensor_outputs(self, env_id: int = 0):
        """The sensors plugin's (noisy, ground truth) readings of one env as
        numpy arrays (nsensordata,); the ground truth is None in eval mode
        (plugin.cpp:64-68), and both are None without the plugin."""
        i, p = self._plugin_of(SensorsPlugin)
        if p is None:
            return None, None
        if not 0 <= env_id < self.nenv:
            raise IndexError(f"env_id {env_id} out of range [0, {self.nenv})")
        with self._lock:
            ps = self.pstates[i]
            noisy = ps["noisy"][env_id].cpu().numpy()
            gt = None if (p.eval_mode or self.eval_mode) else ps["gt"][env_id].cpu().numpy()
        return noisy, gt
