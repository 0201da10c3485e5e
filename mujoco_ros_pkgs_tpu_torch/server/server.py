"""MujocoServer for the torch port: a batch of envs behind the service surface.

Counterpart of mujoco_ros_pkgs_tpu/server/server.py for the requests the
port serves today: stepping (the Step action), pause, reset, reload with
rollback, gravity, control (set_ctrl), equality parameters (get / set, per
env or all), body and batch state, loading state, and the plugins'
services (the sensors plugin's register_noise_models and sensor_outputs,
the mocap plugin's set_mocap_state), and the solver's statistics
(get_solver_stats). Every model it compiles takes the server's broadphase
and active-contact compaction capacities (pair_topk, con_topk).
The batch lives on one device, the card unless the caller asks for
another; each step runs the whole batch through ops/forward.step: one
launch of the fused step kernel for a single free body, or the general
path (with the Cholesky and Newton kernels) for other models and whenever
a plugin is loaded. Plugins (plugins/) hook into every step with their
batched state; their randomness comes from the server's torch.Generator on
the batch's device, seeded by `seed` and re-seeded by `reset`.

Not ported yet: the real-time physics-loop thread, rendering, the
distributed plane, the admin hash and the remaining services. The CLI
(server/launch.py) drives the loop with `tick`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import DisableBit, EqType, JointType, Model
from mujoco_ros_pkgs_tpu_torch.msgs import (
    BodyState, EqualityConstraintParameters, MocapState, Pose, ServiceResult,
    SolverParameters, StateUint, StepResult, Twist,
)
from mujoco_ros_pkgs_tpu_torch.ops import broadphase, solver
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin, PluginRegistry
from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin

# operational status (get_loading_request_state, callbacks.cpp:72-87)
STATUS_RUNNING = 0
STATUS_LOADING = 1

CHUNK = 64     # substeps per batch of work between service requests


class MujocoServer:
    """Batched simulation server.

    Args:
      model: MJCF path or XML string.
      nenv: number of lockstep env instances.
      device: where the batch lives and steps ("cuda" by default; "cpu"
        runs the plain torch versions of the kernels).
      unpause: start running (the CLI's loop advances a running server).
      num_steps: stop after this many steps of the loop (-1 = never).
      plugins: MujocoPlugin instances, loaded on every model the server
        installs (a plugin whose load fails is kept but not called).
      seed: seed of the generator the plugins draw from.
      pair_topk: broadphase compaction capacity of every model the server
        compiles (types.Model.pair_topk; 0 = every pair of the table runs).
      con_topk: active-contact compaction capacity (types.Model.con_topk;
        0 = the solver takes every contact slot).
    """

    def __init__(self, model: str, nenv: int = 1, *, device="cuda",
                 unpause: bool = False, num_steps: int = -1,
                 plugins: Sequence[MujocoPlugin] = (), seed: int = 0,
                 pair_topk: int = 0, con_topk: int = 0):
        self.nenv = int(nenv)
        self.pair_topk = int(pair_topk)
        self.con_topk = int(con_topk)
        if self.nenv < 1:
            raise ValueError(f"nenv must be >= 1, got {nenv}")
        self.device = torch.device(device)
        self.paused = not unpause
        self.num_steps_until_exit = int(num_steps)
        self._plugins = list(plugins)
        self._seed = int(seed)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._seed)
        self._lock = threading.RLock()
        self._status = STATUS_LOADING
        self._load_error = ""
        self._install(*self._compile(model), model)

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    def _compile(self, source: str):
        """Compile a model and its step plan; raises on a bad or unsupported
        model without touching the served state."""
        kw = dict(pair_topk=self.pair_topk, con_topk=self.con_topk)
        if "<" in source:
            m = mjcf.load_model_from_string(source, **kw)
        else:
            m = mjcf.load_model(source, **kw)
        m = m.to(self.device, torch.float32)
        return m, fwd.make_plan(m)

    def _install(self, m: Model, plan, source: str):
        self.m = m
        self._plan = plan
        self._model_source = source
        self.d = fwd.make_data(m, self.nenv)
        self.registry = PluginRegistry()
        for p in self._plugins:
            self.registry.register(p, m, self.d)
        self.pstates = self.registry.init_states(m, self.nenv)
        self._hooks = (self.registry.control_hook(), self.registry.passive_hook(),
                       self.registry.last_stage_hook())
        self._status = STATUS_RUNNING
        self._load_error = ""

    def reload(self, model: str = "") -> ServiceResult:
        """Reload the current or a new model, with the server's pair_topk and
        con_topk; on failure the old model keeps serving
        (initModelFromQueue, mujoco_env.cpp:851-869)."""
        source = model or self._model_source
        with self._lock:
            self._status = STATUS_LOADING
            try:
                m, plan = self._compile(source)
            except (ValueError, NotImplementedError, SyntaxError, OSError) as exc:
                # ET.ParseError is a SyntaxError
                self._load_error = f"{type(exc).__name__}: {exc}"
                self._status = STATUS_RUNNING
                return ServiceResult(False, self._load_error)
            self._install(m, plan, source)
        return ServiceResult(True, "")

    def get_loading_request_state(self) -> StateUint:
        desc = {STATUS_RUNNING: "simulation ready",
                STATUS_LOADING: "loading in progress"}[self._status]
        return StateUint(self._status, desc)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _run(self, nsteps: int):
        """nsteps steps of the batch, each with the plugins' control and
        passive hooks inside and their last stage after it (the JAX
        server's hooked step)."""
        with self._lock:
            m, plan, d, ps = self.m, self._plan, self.d, self.pstates
            control, passive, last = self._hooks
            for _ in range(nsteps):
                if control or passive:
                    d, ps = fwd.step(m, d, plan, control, passive, hstate=ps)
                else:
                    d = fwd.step(m, d, plan)
                if last:
                    d, ps = last(m, d, ps, self._generator)
            self.d, self.pstates = d, ps

    def step(self, nsteps: int = 1) -> StepResult:
        """The Step action (callbacks.cpp:94-129): rejected while running
        and for nsteps <= 0; advances in chunks of CHUNK substeps."""
        if not self.paused or nsteps <= 0:
            return StepResult(success=False)
        left = nsteps
        while left > 0:
            chunk = min(left, CHUNK)
            self._run(chunk)
            left -= chunk
        return StepResult(success=True)

    def tick(self) -> int:
        """One pass of the physics loop: a running server advances one chunk
        (bounded by num_steps); returns the substeps taken."""
        if self.paused or self.num_steps_until_exit == 0:
            return 0
        chunk = CHUNK
        if self.num_steps_until_exit > 0:
            chunk = min(chunk, self.num_steps_until_exit)
            self.num_steps_until_exit -= chunk
        self._run(chunk)
        return chunk

    @property
    def sim_time(self) -> float:
        with self._lock:
            return float(self.d.time[0])

    # ------------------------------------------------------------------
    # services
    # ------------------------------------------------------------------

    def set_pause(self, paused: bool) -> ServiceResult:
        with self._lock:
            self.paused = bool(paused)
        return ServiceResult(True, "")

    def reset(self) -> ServiceResult:
        """mj_resetData of every env and the plugins' reset
        (resetSim, mujoco_env.cpp:246-264): the equalities' activity goes
        back to eq_active0 (their parameters stay as last set), plugin state
        is rebuilt (noise models registered at run time are kept) and the
        generator re-seeded."""
        with self._lock:
            self.d = fwd.make_data(self.m, self.nenv)
            self.registry.reset_all(self.m, self.d)
            self.pstates = self.registry.init_states(self.m, self.nenv)
            self._generator.manual_seed(self._seed)
        return ServiceResult(True, "")

    def get_gravity(self) -> np.ndarray:
        return self.m.opt.gravity.cpu().numpy()

    def set_gravity(self, gravity) -> ServiceResult:
        """Edits the model's gravity, which the general path reads, and on
        the fused route the packed params its kernel reads, in place: no
        recompile, no rebuild of the plan."""
        g = torch.as_tensor(np.asarray(gravity, dtype=np.float64).reshape(3),
                            dtype=torch.float32, device=self.device)
        with self._lock:
            self.m.opt.gravity = g.clone()
            if isinstance(self._plan, step_tpu.Plan):
                off = self._plan.idx["gravity"][0]
                enabled = not self.m.opt.disableflags & DisableBit.GRAVITY
                self._plan.params[off:off + 3] = g if enabled else 0.0
        return ServiceResult(True, "")

    def set_ctrl(self, values, env_id: Optional[int] = None) -> ServiceResult:
        """Write the control vector (nu,) of every env (env_id None) or of
        one env, into the batch's ctrl tensor on its device; the next step
        reads it."""
        vals = np.asarray(values, dtype=np.float64)
        if vals.shape != (self.m.nu,):
            return ServiceResult(False, f"ctrl needs shape ({self.m.nu},), got {vals.shape}")
        if env_id is not None and not 0 <= env_id < self.nenv:
            return ServiceResult(False, f"bad env_id {env_id}")
        with self._lock:
            ctrl = self.d.ctrl
            v = torch.as_tensor(vals, dtype=ctrl.dtype).to(ctrl.device)
            if env_id is None:
                ctrl.copy_(v.expand_as(ctrl))
            else:
                ctrl[env_id] = v
        return ServiceResult(True, "")

    def _env_slice(self, env_id: int):
        """The batch's state of one env, as a batch of one (every tensor of
        Data and its contact set, sliced)."""
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
        count and iteration limit, a diagnostic re-solve's Newton trips,
        gradient norm and cost (ops/solver.solve_stats), and the
        overlapping pairs the broadphase compaction dropped
        (`broadphase_overflow`, 0 without pair_topk)."""
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
        st.mass = float(m.body_mass[b])
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

    # ------------------------------------------------------------------
    # equality constraints
    # ------------------------------------------------------------------

    def get_eq_constraint_parameters(self, name: str, env_id: int = 0
                                     ) -> EqualityConstraintParameters:
        """GetEqualityConstraintParameters: the model's parameters of the
        named equality and its activity in env env_id."""
        m = self.m
        e = m.eq_names.index(name)
        with self._lock:
            data = m.eq_data[e].double().cpu().numpy()
            solref = m.eq_solref[e].double().cpu().numpy()
            solimp = m.eq_solimp[e].double().cpu().numpy()
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

    def set_eq_constraint_parameters(self, p: EqualityConstraintParameters
                                     ) -> ServiceResult:
        """SetEqualityConstraintParameters (callbacks.cpp:641-884): the
        equality's solver parameters and data (connect: anchor; weld:
        anchor, relpose with its quaternion normalised, torquescale; joint:
        polycoef) for every env, replaced on the batch's device; its
        activity in one env (p.env_id) or in all. The row layout does not
        change: an equality's rows are always present, gated by
        d.eq_active."""
        m = self.m
        if p.name not in m.eq_names:
            return ServiceResult(False, f"equality '{p.name}' not found")
        if p.env_id is not None and not 0 <= p.env_id < self.nenv:
            return ServiceResult(False, f"bad env_id {p.env_id}")
        e = m.eq_names.index(p.name)
        with self._lock:
            data = m.eq_data.double().cpu().numpy().copy()
            solref = m.eq_solref.double().cpu().numpy().copy()
            solimp = m.eq_solimp.double().cpu().numpy().copy()
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

            def put(a, like):
                return torch.as_tensor(a, dtype=like.dtype).to(like.device)
            self.m = dataclasses.replace(m, eq_data=put(data, m.eq_data),
                                         eq_solref=put(solref, m.eq_solref),
                                         eq_solimp=put(solimp, m.eq_solimp))
            envs = slice(None) if p.env_id is None else p.env_id
            self.d.eq_active[envs, e] = bool(p.active)
        return ServiceResult(True, "")

    # ------------------------------------------------------------------
    # plugin-backed services
    # ------------------------------------------------------------------

    def _plugin_of(self, cls):
        for i, p in enumerate(self.registry.cb_ready):
            if isinstance(p, cls):
                return i, p
        return None, None

    def set_mocap_state(self, state: MocapState) -> ServiceResult:
        """mocap/set_mocap_state: the mocap plugin's targets of the named
        mocap bodies in every env (state.env_id None) or one; fails on a
        name that is not a mocap body (mocap_plugin.cpp:50-70)."""
        i, p = self._plugin_of(MocapPlugin)
        if p is None:
            return ServiceResult(False, "no mocap plugin loaded")
        if state.env_id is not None and not 0 <= state.env_id < self.nenv:
            return ServiceResult(False, f"bad env_id {state.env_id}")
        with self._lock:
            states = list(self.pstates)
            states[i], res = p.set_state(states[i], state)
            self.pstates = tuple(states)
        return res

    def register_noise_models(self, models) -> ServiceResult:
        """sensors/register_noise_models: the sensors plugin keeps the
        models of known sensors and every env's noise parameters follow;
        fails when a model names an unknown sensor (the others are kept)."""
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
            gt = None if p.eval_mode else ps["gt"][env_id].cpu().numpy()
        return noisy, gt
