"""The port's CUDA kernels against their plain torch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX installed (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Tests marked `gpu` skip without a CUDA device.
"""

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu_torch import kernels
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu

BOXES_DAMPED = worlds.BOXES.replace(
    "<freejoint/>", '<joint type="free" damping="0.05" armature="0.01"/>')
CAPSULE_CONDIM6 = """
<mujoco>
  <option cone="elliptic"/>
  <worldbody>
    <geom type="plane" size="5 5 1"/>
    <body pos="0 0 0.12">
      <freejoint/>
      <geom type="capsule" fromto="-0.1 0 0 0.1 0 0" size="0.05" condim="6"/>
      <geom type="sphere" pos="0 0.08 0" size="0.04" condim="1" priority="1"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_kernel_wrapper_rejects_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises instead of falling back."""
    z = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="not a CUDA device"):
        kernels.step_fused(torch.zeros(4, dtype=torch.int32), torch.zeros(4), z,
                           z[:, :6], z[:, :6])


def test_kernel_sources_hash_into_library_name():
    assert kernels.library_path().name.startswith("libmrp_kernels_")
    assert kernels.library_path() == kernels.library_path()


@pytest.mark.gpu
@pytest.mark.parametrize("xml", [worlds.BOXES, BOXES_DAMPED, CAPSULE_CONDIM6],
                         ids=["boxes", "boxes_damped", "capsule_condim6"])
def test_kernel_matches_plain_on_card(xml):
    """One fused step on the card, kernel against plain version, at the
    tolerances of chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = mjcf.load_model_from_string(xml, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    rng = np.random.default_rng(5)
    n = 512
    qpos = np.zeros((n, 7), np.float32)
    qpos[:, 2] = 0.02 + 0.25 * rng.uniform(size=n)
    quat = rng.normal(size=(n, 4)) * 0.2
    quat[:, 0] += 1.0
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = (0.6 * rng.normal(size=(n, 6))).astype(np.float32)
    qpos, qvel = torch.from_numpy(qpos).cuda(), torch.from_numpy(qvel).cuda()
    ws = torch.zeros_like(qvel)
    before = kernels.step_fused.launches
    kq, kv, kx = step_tpu.step_batched(m, qpos, qvel, ws, plan)
    torch.cuda.synchronize()
    assert kernels.step_fused.launches == before + 1
    pq, pv, px = step_tpu.step_batched_plain(m, qpos, qvel, ws, plan.params, plan.idx)
    torch.testing.assert_close(kq, pq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kx, px, rtol=1e-4, atol=1e-4)
