"""The contact compactions BASELINE runs PILE and HUMANOID with: the
broadphase's top-k pairs (m.pair_topk, ops/broadphase.py and
narrowphase.collide) and the active-contact top-k (m.con_topk,
efc.make_efc and the general Newton), plus the nv > 96 route.

One float64 JAX model, PILE with pair_topk=24 and con_topk=8 (every
contact group compacted: the static group of 51 slots with static body
ids, the dynamic group of 168 with per-env ones from dyn_pair), held
against the port on seeded heaps (tests/torch_problems.pile_heap, 18-22
active slots an env, so that con_topk=8 drops active slots):

- the compile (model_from_numpy of the JAX model carries both capacities),
  the slot layout, n_dyn_slots and, slot by slot, the contacts and
  dyn_pair of one collide: equal / 1e-12;
- candidate_overflow at K = 24 and K = 1 on the same poses: equal;
- the compacted cone blocks (J, aref, D, R, sigma, active, the canonical
  destination rows): 1e-12;
- one step (qpos, qvel, qacc, efc_force_contact) against jax.vmap(step):
  rtol / atol 1e-8, test_torch_newton's tolerance for the Newton solve
  (the same algorithm in float64, sums in another order);
- pair_scores against the JAX package's on the plane / sphere world of its
  test_scores_plane_halfspace.

Torch only, float64: con_topk=64 and pair_topk=24 against the uncompacted
port (whose every active slot survives the compaction; equal at 1e-12:
a product over fewer rows may group its sums differently). The nv = 102
world's step is in tests/test_torch_pile.py, get_solver_stats in
tests/test_torch_server.py.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.core.types import GeomType as JGeomType
from mujoco_ros_pkgs_tpu.ops import broadphase as jbp
from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import narrowphase as jnphase
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import GeomType
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import broadphase, collision, efc, linalg_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _jax_batch, _to_port
from tests.torch_problems import PILE17, pile_heap
from tests.torch_jax import jax_load

NENV = 3
PAIR_K, CON_K = 24, 8


@pytest.fixture(scope="module")
def pile():
    """PILE with pair_topk=24, con_topk=8 in both packages (float64), the
    JAX batch of seeded heaps after its position stage and collide, and its
    efc rows (one jit), and the port's rows of the same state."""
    jm = jax_load(worlds.PILE, pair_topk=PAIR_K, con_topk=CON_K)
    pm = mjcf.load_model_from_string(worlds.PILE, pair_topk=PAIR_K, con_topk=CON_K)
    qpos, qvel = pile_heap(pm, NENV, seed=11)
    jd0 = _jax_batch(jm, qpos, qvel, jnp.float64, seed=11)

    def rows(d):
        d = jsmooth.fwd_position_smooth(jm, d)
        d = jcollision.collide(jm, d)
        d = jsmooth.fwd_acceleration_smooth(jm, jsmooth.fwd_velocity_smooth(jm, d))
        return d, jefc.make_efc(jm, d)
    jd, je = jax.jit(jax.vmap(rows))(jd0)
    pd = _to_port(jd)
    return jm, pm, jd0, jd, je, pd, efc.make_efc(pm, pd)


def test_slot_layout_matches_jax(pile):
    """pair_topk=24 compacts PILE's box-box (30 pairs), sphere-box (36) and
    capsule-box (27) groups: 219 slots (51 static, then 96 + 24 + 48
    dynamic), the same slot_meta and n_dyn_slots as the JAX package; the
    canonical row count stays 3 per slot."""
    jm, pm = pile[:2]
    assert narrowphase.slot_meta(pm) == jnphase.slot_meta(jm)
    assert narrowphase.n_dyn_slots(pm) == jnphase.n_dyn_slots(jm) == 168
    g1, _, _ = narrowphase.slot_meta(pm)
    assert len(g1) == 219 and g1.index(-2) == 51 and set(g1[51:]) == {-2}
    compacted = [(narrowphase._DISPATCH[g["key"][1:3]].name, len(g["pairs"]), g["dyn_base"])
                 for g in narrowphase.pair_groups(pm) if g["topk"]]
    assert compacted == [("_box_box", 30, 51), ("_sphere_box", 36, 147),
                         ("_capsule_box", 27, 171)]
    assert efc.row_layout(pm)["nrow"] == 3 * 219
    assert fwd.make_data(pm, 2).contact.dyn_pair.shape == (2, 168, 2)
    p0 = mjcf.load_model_from_string(worlds.PILE)
    assert narrowphase.n_dyn_slots(p0) == 0 and len(narrowphase.slot_meta(p0)[0]) == 261


def test_model_from_numpy_carries_the_capacities(pile):
    """core/convert.model_from_numpy of the JAX package's compiled model
    carries pair_topk and con_topk, and equals the port's own compile."""
    jm, pm = pile[:2]
    cm = model_from_numpy(*jax_model_to_numpy(jm))
    assert (cm.pair_topk, cm.con_topk) == (pm.pair_topk, pm.con_topk) == (PAIR_K, CON_K)
    assert_models_equal(pm, cm)


def test_contacts_and_dyn_pair_match_jax(pile):
    """One collide of the same geom poses: every contact field slot by slot
    at 1e-12 and dyn_pair (each env's K most-overlapping pairs in top_k's
    order) equal."""
    jm, pm, _, jd, _, pd, _ = pile
    c = collision.collide(pm, pd).contact
    np.testing.assert_array_equal(c.dyn_pair.numpy(), np.asarray(jd.contact.dyn_pair))
    for f in ("dist", "pos", "frame", "includemargin", "friction", "solref", "solimp"):
        np.testing.assert_allclose(getattr(c, f).numpy(), np.asarray(getattr(jd.contact, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    active = (c.dist < c.includemargin).sum(1)
    assert int(active.min()) > CON_K, "the heaps should have more active slots than K"
    assert int((c.dist[:, 51:] < c.includemargin[:, 51:]).sum()) > 0


@pytest.mark.parametrize("k", [PAIR_K, 1])
def test_candidate_overflow_matches_jax(pile, k):
    """The overlapping pairs the compaction drops, per env, on the heaps'
    poses: 0 at K = 24, some at K = 1, as the JAX package counts them."""
    jm, pm, _, jd, _, pd, _ = pile
    jmk = jm.replace(pair_topk=k)
    pmk = pm if k == PAIR_K else mjcf.load_model_from_string(worlds.PILE, pair_topk=k)
    want = np.asarray(jax.vmap(lambda d: jbp.candidate_overflow(jmk, d))(jd))
    got = broadphase.candidate_overflow(pmk, pd).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all() if k == PAIR_K else (got > 0).all()


def test_compacted_rows_match_jax(pile):
    """Both cone groups compacted to each env's 8 deepest slots (JAX: top_k,
    then sorted): J, aref, D, R, sigma, the active flags and the canonical
    rows of each block against the JAX package's cb_* fields at 1e-12; the
    solver's view takes these blocks, and the K2 gate still counts 657
    canonical rows."""
    _, pm, _, _, je, _, pe = pile
    assert [b is not None for b in pe.cb] == [True, True]
    assert len(je.cb_J) == 2 and all(dst is None for dst in je.cb_dest)
    for k, blk in enumerate(pe.cb):
        assert blk.J.shape == (NENV, CON_K, 3, pm.nv)
        for name, got, want in (("J", blk.J, je.cb_J[k]), ("aref", blk.aref, je.cb_aref[k]),
                                ("D", blk.D, je.cb_D[k]), ("R", blk.R, je.cb_R[k]),
                                ("sigma", blk.sigma, je.cb_sigma[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                       atol=1e-12, err_msg=f"block {k} {name}")
        np.testing.assert_array_equal(blk.act.numpy(), np.asarray(je.cb_act[k]))
        np.testing.assert_array_equal(blk.idx.reshape(NENV, -1).numpy(),
                                      np.asarray(je.cb_dest_dyn[k]))
        assert bool(blk.act.any())
    assert len(pe.kinds) == 657


def test_step_matches_jax(pile):
    """One float64 step of the heaps with both compactions against
    jax.vmap(fwd.step): qpos, qvel, qacc and the row forces (a dropped
    slot's rows exactly 0) at rtol / atol 1e-8."""
    jm, pm, jd0, *_ = pile
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd0)
    pd = fwd.step(pm, _to_port(jd0))
    for f in ("qpos", "qvel", "qacc", "efc_force_contact"):
        np.testing.assert_allclose(getattr(pd, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    nonzero = (pd.efc_force_contact[:, ::3] != 0).sum(1)
    assert int(nonzero.max()) <= 2 * CON_K and int(nonzero.min()) > 0


def test_scores_plane_halfspace():
    """Plane pairs score by halfspace distance, finite pairs by sphere
    separation, both negative where the bounding volumes overlap; equal to
    the JAX package's scores of the same poses and geoms at 1e-12."""
    xml = """
    <mujoco>
      <worldbody>
        <geom name="gnd" type="plane" size="5 5 1"/>
        <body pos="0 0 2"><freejoint/>
          <geom name="s1" type="sphere" size="0.5" mass="1"/></body>
        <body pos="3 0 0.4"><freejoint/>
          <geom name="s2" type="sphere" size="0.5" mass="1"/></body>
      </worldbody>
    </mujoco>"""
    pm = mjcf.load_model_from_string(xml)
    d = fwd.step(pm, fwd.make_data(pm, 1))
    # the JAX function reads these four fields: the port's, as jax arrays
    jm = types.SimpleNamespace(geom_rbound=jnp.asarray(pm.geom_rbound.numpy()),
                               geom_margin=jnp.asarray(pm.geom_margin.numpy()))
    jd = types.SimpleNamespace(geom_xpos=jnp.asarray(d.geom_xpos[0].numpy()),
                               geom_xmat=jnp.asarray(d.geom_xmat[0].numpy()))
    cases = (([0], [1], GeomType.PLANE, lambda s: s > 1.0),
             ([0], [2], GeomType.PLANE, lambda s: s < 0.0),
             ([1], [2], GeomType.SPHERE, lambda s: 1.5 < s < 2.5))
    for g1, g2, t1, ok in cases:
        got = broadphase.pair_scores(pm, d, np.array(g1), np.array(g2), t1)
        want = jbp.pair_scores(jm, jd, np.array(g1), np.array(g2), JGeomType(int(t1)))
        assert got.shape == (1, 1) and ok(float(got[0, 0]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pair_topk,con_topk", [(0, 64), (24, 0), (24, 64)])
def test_compacted_step_matches_uncompacted(pair_topk, con_topk):
    """Torch only, float64: 3 steps of seeded heaps (16 active slots an
    env, under every K) with each compaction against the uncompacted
    port, qpos, qvel, qacc and the total contact force at 1e-12."""
    m0 = mjcf.load_model_from_string(worlds.PILE)
    mk = mjcf.load_model_from_string(worlds.PILE, pair_topk=pair_topk, con_topk=con_topk)
    qpos, qvel = pile_heap(m0, 2, seed=4)
    out = []
    for m in (m0, mk):
        d = fwd.make_data(m, 2).replace(qpos=torch.from_numpy(qpos),
                                        qvel=torch.from_numpy(qvel))
        for _ in range(3):
            d = fwd.step(m, d)
        out.append(d)
    d0, dk = out
    assert int((dk.contact.dist < dk.contact.includemargin).sum(1).max()) < 64
    for f in ("qpos", "qvel", "qacc"):
        np.testing.assert_allclose(getattr(dk, f).numpy(), getattr(d0, f).numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(dk.efc_force_contact.sum(1).numpy(),
                               d0.efc_force_contact.sum(1).numpy(), rtol=1e-12, atol=1e-12)
    if not pair_topk:
        np.testing.assert_allclose(dk.efc_force_contact.numpy(),
                                   d0.efc_force_contact.numpy(), rtol=1e-12, atol=1e-12)
