"""K3's device time on BOXES in two checkouts of the repository, on one
card, in the order a, b, b, a.

    python scripts/k3_ab.py A_DIR [B_DIR]

B_DIR defaults to the current directory. Each run is a process of its own
started from a checkout's root: it builds that checkout's kernels (into
its own mujoco_ros_pkgs_tpu_torch/_build) and times kernels.step_fused by
that checkout's chip_smoke.graph_ms (CUDA-graph replays of 20 calls) on
chip_smoke.states() at 4096 and 65536 envs and at each group width, three
readings each; it prints one JSON line. The script prints the card's name
and power limit and a table of the medians.
"""

import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mujoco_ros_pkgs_tpu_torch import kernels
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
kernels.build()
m = mjcf.load_model_from_string(worlds.BOXES, dtype=torch.float32).to("cuda")
plan = fwd.make_plan(m)
out = {}
for n in (4096, 65536):
    q, v, w = cs.states(n, seed=1)
    for g in kernels.GROUP_WIDTHS:
        with cs.forced_width(g):
            reads = [cs.graph_ms(lambda: kernels.step_fused(plan.meta, plan.params, q, v, w,
                                                            plan.rows), 100)
                     for _ in range(3)]
        out[f"{n} G={g}"] = statistics.median(reads)
print("K3AB " + json.dumps(out))
"""


def run(root: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        sys.exit(f"{root}: exit {res.returncode}\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    line = [x for x in res.stdout.splitlines() if x.startswith("K3AB ")][-1]
    return json.loads(line[5:])


def main():
    a = Path(sys.argv[1]).resolve()
    b = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    runs = [("a", run(a)), ("b", run(b)), ("b", run(b)), ("a", run(a))]
    print(f"K3 graph_ms on BOXES, runs a / b / b / a (a = {a}, b = {b}; {card})")
    for key in runs[0][1]:
        print(f"  {key}: " + " / ".join(f"{r[key]:.5f}" for _, r in runs))
    print(json.dumps({"card": card, "runs": [dict(r, checkout=k) for k, r in runs]}))


if __name__ == "__main__":
    main()
