"""Plugin system: the reference's MujocoPlugin as step hooks over a batch.

Counterpart of mujoco_ros_pkgs_tpu/plugins/base.py. Reference API
(mujoco_ros/include/mujoco_ros/plugin_utils.h:45-161): plugins are classes
with callbacks controlCallback / passiveCallback / lastStageCallback plus
load/reset, invoked from inside mj_step via mjcb_control/mjcb_passive and
after each step (mujoco_ros/src/callbacks.cpp:131-157). Failed plugins are
quarantined but kept (plugin_utils.h:69-78).

Here a hook is a function of the whole batch: it takes the batch-first
Data and the plugin's state (tensors with a leading env axis, made by
`init_state`) and returns both, new. Randomness comes from an explicit
torch.Generator handed to the last stage, not from the state.

Hook order inside one step (SURVEY.md section 3.2):
    control(m, d, ps)               - mjcb_control: before actuation
    passive(m, d, ps)               - mjcb_passive: after the passive forces
    last_stage(m, d, ps, generator) - after integration, once per step
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model


class MujocoPlugin:
    """Base plugin. Subclasses override any subset of the hooks.

    Config is an arbitrary dict (the XmlRpc struct of the reference,
    plugin_utils.h:51-57). `init_state` returns the plugin's batched state.
    """

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self.loaded = False          # cb-ready gate (quarantine semantics)
        self.load_error = ""

    # -- lifecycle (host side) --
    def load(self, m: Model, d: Data) -> bool:
        """Called once after model load. Return False to quarantine."""
        return True

    def reset(self, m: Model, d: Data) -> None:
        """Called on simulation reset."""

    def init_state(self, m: Model, nenv: int) -> Any:
        """The plugin's state for a batch of nenv envs, on the model's device."""
        return ()

    # -- hooks over the whole batch --
    def control(self, m: Model, d: Data, ps: Any) -> Tuple[Data, Any]:
        return d, ps

    def passive(self, m: Model, d: Data, ps: Any) -> Tuple[Data, Any]:
        return d, ps

    def last_stage(self, m: Model, d: Data, ps: Any,
                   generator: torch.Generator) -> Tuple[Data, Any]:
        return d, ps

    # -- host-side notifications --
    def on_geom_changed(self, m: Model, geom_id: int) -> None:
        """Called after set_geom_properties edited geom `geom_id` of the
        served model m (the reference's onGeomChanged, plugin_utils.h:135)."""


class PluginRegistry:
    """Ordered plugin set with quarantine semantics (plugin_utils.cpp:83-112).

    A plugin whose load() fails stays registered but is excluded from the
    callback-ready set, mirroring `plugins_` vs `cb_ready_plugins_`."""

    def __init__(self):
        self.plugins: List[MujocoPlugin] = []

    def register(self, plugin: MujocoPlugin, m: Model, d: Data) -> bool:
        self.plugins.append(plugin)
        try:
            ok = plugin.load(m, d)
        except Exception as exc:  # quarantine, don't kill the server
            plugin.load_error = str(exc)
            ok = False
        plugin.loaded = bool(ok)
        return plugin.loaded

    @property
    def cb_ready(self) -> List[MujocoPlugin]:
        return [p for p in self.plugins if p.loaded]

    def init_states(self, m: Model, nenv: int) -> Tuple[Any, ...]:
        return tuple(p.init_state(m, nenv) for p in self.cb_ready)

    def reset_all(self, m: Model, d: Data) -> None:
        # failed plugins are skipped on reset (mujoco_env.cpp:428-432)
        for p in self.cb_ready:
            p.reset(m, d)

    # composed hooks over the ready set, in registration order; None when
    # no plugin is ready, so that the step keeps its route
    def _compose(self, name: str):
        ready = self.cb_ready
        if not ready:
            return None

        def hook(m, d, states, *args):
            out = []
            for p, ps in zip(ready, states):
                d, nps = getattr(p, name)(m, d, ps, *args)
                out.append(nps)
            return d, tuple(out)
        return hook

    def control_hook(self):
        return self._compose("control")

    def passive_hook(self):
        return self._compose("passive")

    def last_stage_hook(self):
        return self._compose("last_stage")
