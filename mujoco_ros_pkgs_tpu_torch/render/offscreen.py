"""Offscreen camera streams: throttled by sim time, lazy without subscribers.

Counterpart of mujoco_ros_pkgs_tpu/render/offscreen.py, after the
reference's streams (offscreen_camera.cpp): one stream per model camera
(cameras/<name>/{rgb,depth,segmented} and camera_info), configured by
cam_config/<name>/{stream_type, frequency, use_segid, width, height} with
the defaults RGB, 15 Hz, 720 x 480 and segment ids
(offscreen_rendering.cpp:95-99); each stream renders once its period of
sim time has passed (shouldRender, :159-163) and only while someone takes
its frames: a subscriber or a PNG directory (:168-174).

Batch first: a stream renders its `env_ids` in one call of
render/camera.render on the batch's device; a frame is a dict of numpy
arrays (N, H, W, ...) over those envs. `png_dir` writes each frame's
images (the viewer's screenshot path, viewer.cpp:2231-2245).
"""

from __future__ import annotations

import enum
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model
from mujoco_ros_pkgs_tpu_torch.render import camera as rcam
from mujoco_ros_pkgs_tpu_torch.utils import png


class StreamType(enum.IntFlag):
    """The stream bitmask (common_types.h:50-60)."""
    RGB = 1
    DEPTH = 2
    SEGMENTED = 4

    @classmethod
    def parse(cls, value) -> "StreamType":
        """An int, or names joined by '|' as a config file spells them
        ("RGB|DEPTH", any case)."""
        if isinstance(value, str):
            out = cls(0)
            for name in value.split("|"):
                out |= cls[name.strip().upper()]
            return out
        return cls(int(value))


class OffscreenCameraStream:
    """One camera's stream (the reference's OffscreenCamera)."""

    def __init__(self, m: Model, name: str, stream_type=StreamType.RGB,
                 frequency: float = 15.0, width: int = 720, height: int = 480,
                 use_segid: bool = True, env_ids: Sequence[int] = (0,),
                 png_dir: Optional[str] = None):
        self.cam_id = m.cam_names.index(name)
        self.name = name
        self.stream_type = StreamType.parse(stream_type)
        self.frequency = float(frequency)
        self.width = int(width)
        self.height = int(height)
        self.use_segid = bool(use_segid)
        self.env_ids: Tuple[int, ...] = tuple(int(e) for e in env_ids)
        self.png_dir = png_dir
        self.last_pub_time = -1.0
        self.frame_count = 0
        self.subscribers: List[Callable[[dict], None]] = []

    @property
    def live(self) -> bool:
        """Whether anyone takes the frames (offscreen_camera.cpp:168-174)."""
        return bool(self.subscribers or self.png_dir)

    def should_render(self, t: float) -> bool:
        """offscreen_camera.cpp:159-163."""
        return t - self.last_pub_time >= (1.0 / self.frequency) - 1e-9

    def steps_until_due(self, t: float, dt: float) -> int:
        """Steps of dt from sim time t until should_render holds (1 when it
        holds already: frames are taken after a step)."""
        wait = self.last_pub_time + 1.0 / self.frequency - 1e-9 - t
        return max(1, math.ceil(wait / dt - 1e-6))

    def camera_info(self, m: Model) -> dict:
        return rcam.camera_intrinsics(m, self.cam_id, self.width, self.height)

    def render_now(self, m: Model, d: Data, markers=()):
        """The configured envs' (rgb (N, H, W, 3), depth (N, H, W), seg
        (N, H, W)) as tensors on d's device; `markers` are the plugins'
        visual geoms (render/camera.RenderMarker)."""
        return rcam.render(m, d, self.cam_id, self.width, self.height, markers,
                           self.env_ids)

    def render_and_publish(self, m: Model, d: Data, sim_time: float,
                           markers=()) -> Optional[dict]:
        """Render and hand the frame to the subscribers and the PNG
        directory; None when nobody takes it or it is not due."""
        if not self.live or not self.should_render(sim_time):
            return None
        rgb, depth, seg = self.render_now(m, d, markers)
        msg = {"time": sim_time, "camera": self.name, "env_ids": self.env_ids}
        if self.stream_type & StreamType.RGB:
            msg["rgb"] = rgb.cpu().numpy()
        if self.stream_type & StreamType.DEPTH:
            msg["depth"] = depth.cpu().numpy()
        if self.stream_type & StreamType.SEGMENTED:
            seg_arr = seg.cpu().numpy()
            msg["segmented"] = seg_arr if self.use_segid else seg_arr.astype(np.float32)
        self.last_pub_time = sim_time
        self.frame_count += 1
        if self.png_dir:
            self._dump_pngs(msg)
        for cb in self.subscribers:
            cb(msg)
        return msg

    def _dump_pngs(self, msg: dict) -> None:
        os.makedirs(self.png_dir, exist_ok=True)
        stem = os.path.join(self.png_dir, f"{self.name}_{self.frame_count:06d}")
        for i, env in enumerate(self.env_ids):
            if "rgb" in msg:
                png.write(f"{stem}_env{env}_rgb.png", msg["rgb"][i])
            if "depth" in msg:
                png.write(f"{stem}_env{env}_depth.png", msg["depth"][i])
            if "segmented" in msg:
                # 16-bit gray: every realistic id (markers past ngeom too),
                # the background (-1) at 0
                seg16 = (msg["segmented"][i].astype(np.int32) + 1).astype(np.uint16)
                png.write(f"{stem}_env{env}_seg.png", seg16)


class OffscreenRenderManager:
    """Every camera stream of a server (the offscreen render loop's role,
    without its thread: the server renders between chunks of steps)."""

    def __init__(self, m: Model, cam_config: Optional[Dict[str, dict]] = None):
        cam_config = cam_config or {}
        defaults = cam_config.get("*", {})      # applied to every camera
        self.streams: Dict[str, OffscreenCameraStream] = {}
        for name in m.cam_names:
            cfg = {**defaults, **cam_config.get(name, {})}
            self.streams[name] = OffscreenCameraStream(
                m, name, stream_type=cfg.get("stream_type", StreamType.RGB),
                frequency=cfg.get("frequency", 15.0), width=cfg.get("width", 720),
                height=cfg.get("height", 480), use_segid=cfg.get("use_segid", True),
                env_ids=cfg.get("env_ids", (0,)), png_dir=cfg.get("png_dir"))

    def subscribe(self, name: str, cb: Callable[[dict], None]) -> None:
        self.streams[name].subscribers.append(cb)

    @property
    def live(self) -> bool:
        return any(s.live for s in self.streams.values())

    def steps_until_due(self, t: float, dt: float) -> int:
        """Steps until the first live stream is due (live streams only)."""
        return min(s.steps_until_due(t, dt) for s in self.streams.values() if s.live)

    def render_all(self, m: Model, d: Data, sim_time: float, markers=()) -> None:
        for s in self.streams.values():
            s.render_and_publish(m, d, sim_time, markers)
