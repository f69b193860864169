"""The port's whole-body locomotion controller against the JAX package's,
on the CPU.

The port's `control/` is a copy of the JAX package's and runs the same
NumPy, MuJoCo and native QP code, so the same seeded inputs must give equal
outputs: every comparison is `np.array_equal`, no tolerance.
"""

import numpy as np
import pytest

from daydreamer_tpu import control as jcontrol
from daydreamer_tpu.control import kinematics as jkin
from daydreamer_tpu.envs import a1_model as jmodel
from daydreamer_tpu_torch import control as pcontrol
from daydreamer_tpu_torch.control import kinematics as pkin
from daydreamer_tpu_torch.envs import a1_model as pmodel

LOW, HIGH = [-0.7, -0.2, -2.5], [0.7, 2.0, -1.0]


def _angles(seed, n):
  return np.random.default_rng(seed).uniform(LOW, HIGH, (n, 3))


@pytest.mark.parametrize('leg', range(4))
def test_forward_kinematics_matches_jax(leg):
  for q in _angles(leg, 8):
    assert np.array_equal(pkin.foot_position(leg, q),
                          jkin.foot_position(leg, q))
  motors = _angles(10 + leg, 4).reshape(-1)
  assert np.array_equal(pkin.all_foot_positions(motors),
                        jkin.all_foot_positions(motors))


@pytest.mark.parametrize('leg', range(4))
def test_inverse_kinematics_matches_jax(leg):
  for q in _angles(20 + leg, 8):
    target = jkin.foot_position(leg, q)
    assert np.array_equal(pkin.foot_ik(leg, target), jkin.foot_ik(leg, target))
  far = np.array([0.0, -jkin.D, -1.0])  # Beyond the leg's reach.
  assert np.array_equal(pkin.foot_ik(leg, far), jkin.foot_ik(leg, far))


@pytest.mark.parametrize('leg', range(4))
def test_jacobian_matches_jax(leg):
  for q in _angles(30 + leg, 8):
    assert np.array_equal(pkin.foot_jacobian(leg, q),
                          jkin.foot_jacobian(leg, q))


def test_gait_matches_jax():
  gaits = [lib.GaitScheduler(duty_factor=(0.6,) * 4)
           for lib in (pcontrol, jcontrol)]
  rng = np.random.default_rng(0)
  for t in np.linspace(0.0, 1.5, 40):
    contacts = tuple(bool(c) for c in rng.integers(0, 2, 4))
    for gait in gaits:
      gait.update(t, contacts=contacts)
    a, b = gaits
    assert [(l.state, l.nominal_state, l.phase) for l in a.legs] == [
        (l.state, l.nominal_state, l.phase) for l in b.legs]
    assert a.stance_legs() == b.stance_legs()


@pytest.mark.parametrize('legs', [[0, 1, 2, 3], [0, 3], [1, 2, 3]])
def test_stance_qp_forces_match_jax(legs):
  stances = [lib.StanceForceController(lib.GaitScheduler())
             for lib in (pcontrol, jcontrol)]
  rng = np.random.default_rng(len(legs))
  pose = pmodel.unnormalize_action(pmodel.STANDING_POSE)
  wrench = np.array([5.0, -2.0, stances[0]._mass * 9.81, 0.3, -0.2, 0.1])
  wrench += rng.normal(size=6)
  feet = pkin.all_foot_positions(pose)
  forces = [s.contact_forces(wrench, feet, legs) for s in stances]
  assert sorted(forces[0]) == sorted(forces[1]) == legs
  for leg in legs:
    assert np.array_equal(forces[0][leg], forces[1][leg])
  torques = [s.leg_torques(pose, f) for s, f in zip(stances, forces)]
  for leg in legs:
    assert np.array_equal(torques[0][leg], torques[1][leg])
  args = (0.25, 0.05, -0.03, rng.normal(size=3), rng.normal(size=3),
          (0.4, 0.1), 0.2)
  assert np.array_equal(stances[0].desired_wrench(*args),
                        stances[1].desired_wrench(*args))


def test_action_mapping_matches_jax():
  acts = np.random.default_rng(5).uniform(-1, 1, (6, 12))
  for act in acts:
    assert np.array_equal(pmodel.unnormalize_action(act),
                          jmodel.unnormalize_action(act))
    angles = jmodel.unnormalize_action(act)
    assert np.array_equal(pmodel.normalize_action(angles),
                          jmodel.normalize_action(angles))


def test_run_sim_trot_matches_jax():
  """A short closed-loop trot in the MuJoCo A1: the whole-body controller
  (gait, Raibert swing, stance QP) drives the same trajectory."""
  stats = [lib.run_sim(seconds=0.4, command=(0.4, 0.0), yaw_rate=0.2,
                       seed=0) for lib in (pcontrol, jcontrol)]
  for key in ('displacement', 'yaw_change', 'min_uprightness',
              'mean_height'):
    assert np.array_equal(stats[0][key], stats[1][key]), key
  a, b = (s['robot'] for s in stats)
  assert np.array_equal(a.data.qpos, b.data.qpos)
  assert np.array_equal(a.data.qvel, b.data.qvel)
  assert stats[0]['mean_height'] > 0.2
  for robot in (a, b):
    robot.close()
