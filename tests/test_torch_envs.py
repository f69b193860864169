"""The port's environments against the JAX package's, on the CPU.

The port's `envs/` is a copy of the JAX package's: the same seeded actions
through both give equal observations and rewards (`np.array_equal`, no
tolerance: the same NumPy, MuJoCo and OpenCV code runs on both sides).
The renders are off (`render=False`) wherever the image is not compared.
The registry holds the same suites, and a suite whose package is missing
here fails the same way in both.

What imports dm_control (the dmc and loconav suites) runs in a fresh
interpreter: once dm_control is imported with MuJoCo's EGL backend, a later
import of TensorFlow in the same process (TensorBoard's writer in another
test of the same worker) crashes it.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from daydreamer_tpu import envs as jenvs
from daydreamer_tpu_torch import envs as penvs


def _actions(space, steps, seed):
  rng = np.random.default_rng(seed)
  if space.discrete:
    n = space.shape[-1] if space.shape else int(space.high)
    return [np.eye(n, dtype=np.float32)[rng.integers(0, n)]
            for _ in range(steps)]
  return [rng.uniform(space.low, space.high).astype(space.dtype)
          for _ in range(steps)]


def _rollout(env, actions):
  obs = [env.step({'action': actions[0], 'reset': True})]
  for act in actions[1:]:
    obs.append(env.step({'action': act, 'reset': False}))
  return obs


def _assert_same(port_obs, jax_obs, keys=None):
  assert len(port_obs) == len(jax_obs)
  for a, b in zip(port_obs, jax_obs):
    assert set(a) == set(b)
    for key in keys or b:
      assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key


def _assert_same_spaces(port_env, jax_env):
  for port, ref in ((port_env.obs_space, jax_env.obs_space),
                    (port_env.act_space, jax_env.act_space)):
    assert set(port) == set(ref)
    for key in ref:
      assert port[key].dtype == ref[key].dtype, key
      assert port[key].shape == ref[key].shape, key
      assert np.array_equal(port[key].low, ref[key].low), key
      assert np.array_equal(port[key].high, ref[key].high), key


def _both(fn):
  return fn(penvs), fn(jenvs)


def _isolated(call):
  """Evaluates `call`, an expression over this module as `t`, in a fresh
  interpreter; returns its value (a literal)."""
  here = pathlib.Path(__file__).resolve().parent
  code = (f'import sys; sys.path.insert(0, {str(here)!r}); '
          f'import test_torch_envs as t; print(repr({call}))')
  env = dict(os.environ, PYTHONPATH=str(here.parent))
  done = subprocess.run([sys.executable, '-c', code], env=env,
                        capture_output=True, text=True, timeout=300)
  assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
  return ast.literal_eval(done.stdout.strip().splitlines()[-1])


def _modules(name):
  """The module `envs.<name>` of the port, then of the JAX package."""
  return tuple(importlib.import_module(f'{lib.__name__}.{name}')
               for lib in (penvs, jenvs))


def test_registry_has_the_same_suites():
  assert set(penvs.SUITES) == set(jenvs.SUITES)
  assert set(penvs.__all__) == set(jenvs.__all__)


# A task of each suite whose simulator is missing or breaks here.
MISSING = ['atari_pong', 'crafter_reward',
           'dmlab_rooms_collect_good_objects_train', 'minecraft_wood',
           'loconav_ant_maze_s', 'gym_NoSuchEnv-v0', 'nosuite_task']


def _construction_errors(task):
  """The name of the exception that building `task` raises, in the port
  and in the JAX package."""
  errors = []
  for lib in (penvs, jenvs):
    with pytest.raises(Exception) as info:
      lib.load_single_env(task)
    errors.append(info.type.__name__)
  return errors


@pytest.mark.parametrize('task', MISSING)
def test_missing_suite_fails_the_same_way(task):
  if task.startswith('loconav'):
    port, ref = _isolated(f't._construction_errors({task!r})')
  else:
    port, ref = _construction_errors(task)
  assert port == ref, (port, ref)


def test_a1_sim_matches_jax():
  envs = _both(lambda lib: lib.load_single_env(
      'a1_sim', render=False, seed=3, length=20, repeat=5))
  try:
    _assert_same_spaces(*envs)
    # The reset, then 20 steps up to the time limit.
    actions = _actions(envs[0].act_space['action'], 21, seed=0)
    port_obs, jax_obs = (_rollout(env, actions) for env in envs)
    _assert_same(port_obs, jax_obs)
    assert port_obs[-1]['vector'].shape == (16,)
    assert np.isfinite(port_obs[-1]['reward'])
    assert port_obs[-1]['is_last'] and not port_obs[-2]['is_last']
  finally:
    for env in envs:
      env.close()


def test_a1_dummy_spaces_match_jax():
  envs = _both(lambda lib: lib.load_env(
      'a1_dummy', amount=1, parallel='none', length=20))
  try:
    _assert_same_spaces(*envs)
    assert envs[0].obs_space['vector'].shape == (16,)
    assert envs[0].act_space['action'].shape == (12,)
    acts = {'action': np.zeros((1, 12), np.float32),
            'reset': np.ones(1, bool)}
    port_obs, jax_obs = (env.step(acts) for env in envs)
    _assert_same([port_obs], [jax_obs])
  finally:
    for env in envs:
      env.close()


def test_sphero_dummy_matches_jax():
  envs = [module.SpheroEnv(module.EnvConfig(length=20, seed=5))
          for module in _modules('sphero')]
  try:
    _assert_same_spaces(*envs)
    actions = _actions(envs[0].act_space['action'], 20, seed=1)
    port_obs, jax_obs = (_rollout(env, actions) for env in envs)
    _assert_same(port_obs, jax_obs,
                 keys=['image', 'goal', 'reward', 'log_success', 'is_last'])
    assert port_obs[-1]['image'].shape == (64, 64, 3)
  finally:
    for env in envs:
      env.close()


def test_sphero_tracker_matches_jax():
  frame = np.zeros((480, 640, 3), np.uint8)
  frame[:] = (40, 35, 30)
  yy, xx = np.ogrid[:480, :640]
  frame[(xx - 330) ** 2 + (yy - 220) ** 2 <= 400] = (250, 250, 250)
  results = []
  for module in _modules('sphero'):
    tracker = module.BallTracker(
        (0, 0, 160), (180, 80, 255), (193, 67), (480, 370))
    results.append([tracker(frame), tracker(np.zeros_like(frame))])
  for (pos_a, mask_a, found_a), (pos_b, mask_b, found_b) in zip(*results):
    assert found_a == found_b
    assert np.array_equal(pos_a, pos_b)
    assert np.array_equal(mask_a, mask_b)


def test_dmc_walker_walk_matches_jax():
  assert _isolated('t._compare_dmc()') == 'ok'


def _compare_dmc():
  from dm_control import suite
  envs = [lib.load_single_env('dmc_walker_walk', render=False)
          for lib in (penvs, jenvs)]
  _assert_same_spaces(*envs)
  for env in envs:
    env.close()
  # The suite's task is seeded through its own argument.
  envs = [module.DMC(suite.load('walker', 'walk', task_kwargs={'random': 0}),
                     repeat=2, render=False)
          for module in _modules('dmc')]
  try:
    actions = _actions(envs[0].act_space['action'], 12, seed=2)
    port_obs, jax_obs = (_rollout(env, actions) for env in envs)
    _assert_same(port_obs, jax_obs)
    assert set(port_obs[0]) >= {'orientations', 'height', 'velocity'}
  finally:
    for env in envs:
      env.close()
  return 'ok'


def test_gymnasium_env_through_gym_adapter_matches_jax():
  import gymnasium
  envs = []
  for module in _modules('gym'):
    inner = gymnasium.make('CartPole-v1')
    inner.reset(seed=0)  # Later resets continue this stream.
    envs.append(module.Gym(inner, obs_key='state'))
  try:
    _assert_same_spaces(*envs)
    actions = _actions(envs[0].act_space['action'], 40, seed=3)
    actions = [int(np.argmax(a)) for a in actions]
    port_obs, jax_obs = (_rollout(env, actions) for env in envs)
    _assert_same(port_obs, jax_obs)
  finally:
    for env in envs:
      env.close()


def test_hrlgrid_matches_jax():
  envs = _both(lambda lib: lib.load_single_env('hrlgrid_4', length=30))
  _assert_same_spaces(*envs)
  actions = _actions(envs[0].act_space['action'], 60, seed=4)
  port_obs, jax_obs = (_rollout(env, actions) for env in envs)
  _assert_same(port_obs, jax_obs)


def test_minerl_tables_and_smoother_match_jax():
  from daydreamer_tpu.envs import minecraft as jmc
  from daydreamer_tpu.envs import minerl_tasks as jmt
  from daydreamer_tpu_torch.envs import minecraft as pmc
  from daydreamer_tpu_torch.envs import minerl_tasks as pmt
  for task in ('wood', 'table', 'axe', 'diamond', 'discover'):
    assert pmt.full_actions(task) == jmt.full_actions(task)
  assert pmt.REWARDS == jmt.REWARDS and pmt.NOOP == jmt.NOOP
  smoothers = (pmc.ActionSmoother(sticky_attack=3, sticky_jump=2,
                                  pitch_limit=(-30, 30)),
               jmc.ActionSmoother(sticky_attack=3, sticky_jump=2,
                                  pitch_limit=(-30, 30)))
  rng = np.random.default_rng(6)
  for _ in range(30):
    action = dict(jmt.NOOP, attack=int(rng.integers(0, 2)),
                  jump=int(rng.integers(0, 2)),
                  camera=(int(rng.integers(-15, 16)), 0))
    assert smoothers[0](dict(action)) == smoothers[1](dict(action))


def test_action_filter_matches_jax():
  from daydreamer_tpu.envs.drivers import action_filter as jaf
  from daydreamer_tpu_torch.envs.drivers import action_filter as paf
  filters = [lib.ActionFilterButter(sampling_rate=500, dims=12)
             for lib in (paf, jaf)]
  rng = np.random.default_rng(7)
  start = rng.uniform(-1, 1, 12)
  for f in filters:
    f.init_history(start)
  for _ in range(25):
    x = rng.uniform(-1, 1, 12)
    assert np.array_equal(filters[0].filter(x), filters[1].filter(x))


def test_gamepad_matches_jax():
  import io
  import time
  from daydreamer_tpu.envs.drivers import gamepad as jgp
  from daydreamer_tpu_torch.envs.drivers import gamepad as pgp
  events = [(pgp.EV_ABS, pgp.ABS_Y, -32768), (pgp.EV_ABS, pgp.ABS_X, 16384),
            (pgp.EV_ABS, pgp.ABS_RX, -20000), (pgp.EV_KEY, pgp.BTN_TL, 1),
            (pgp.EV_KEY, pgp.BTN_TR, 1), (pgp.EV_ABS, pgp.ABS_Y, -32768)]
  commands = []
  for lib in (pgp, jgp):
    assert lib.pack_event(*events[0]) == jgp.pack_event(*events[0])
    stream = io.BytesIO(b''.join(lib.pack_event(*e) for e in events[:3]))
    pad = lib.Gamepad(vel_scale_x=0.4, vel_scale_y=0.4, vel_scale_rot=1.0,
                      device=stream)
    deadline = time.time() + 2.0
    while pad._thread.is_alive() and time.time() < deadline:
      time.sleep(0.01)
    pad.is_running = False
    commands.append((pad.speed_command(), pad.estop_flagged))
  assert commands[0] == commands[1]
  assert commands[0][0][0] == pytest.approx(0.4)
