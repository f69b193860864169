"""Environment registry and assembly (the dummy and robot suites; the
other suites of the reference package are not ported yet).

Covers the reference's env loading capability (reference:
embodied/envs/__init__.py:17-102) with a registry design: each suite
registers a factory via the ``@suite`` decorator, receiving the task name
and an ``EnvSpec`` of construction options.  ``load_env`` builds N
per-index-seeded instances (optionally each in its own worker process,
crash-restarting, keyboard-pausable) and batches them; action-space
adaptation and the time limit are applied uniformly after the factory.
"""

import dataclasses
import functools
import typing

from .. import core
from ..core import wrappers
from .dummy import Dummy
from .robot import PickPlace, EnvConfig, RobotType

SUITES = {}


def suite(name):
  def register(factory):
    SUITES[name] = factory
    return factory
  return register


@dataclasses.dataclass
class EnvSpec:
  """Construction options shared by all suites (the `env.*` config tree)."""
  size: tuple = (64, 64)
  repeat: int = 1
  mode: str = 'train'
  camera: int = -1
  gray: bool = False
  length: int = 0
  logdir: str = '/dev/null'
  discretize: int = 0
  sticky: bool = True
  lives: bool = False
  episodic: bool = True
  resets: bool = True
  render: bool = True
  seed: typing.Optional[int] = None
  sensor_latency: float = 0.0


@suite('dummy')
def _dummy(task, spec):
  return Dummy(task, spec.size, spec.length or 100)


@suite('xarm')
def _xarm(task, spec):
  assert task in ('real', 'dummy')
  return PickPlace(EnvConfig(
      use_real=(task == 'real'), robot_type=RobotType.XARM, enable_z=True,
      length=spec.length or 100))


@suite('ur5')
def _ur5(task, spec):
  assert task in ('real', 'dummy')
  return PickPlace(EnvConfig(
      use_real=(task == 'real'), robot_type=RobotType.UR5,
      length=spec.length or 100))


def load_single_env(task, **options):
  name, _, subtask = task.partition('_')
  if name not in SUITES:
    raise NotImplementedError(name)
  spec = EnvSpec(**options)
  env = SUITES[name](subtask, spec)
  # Uniform action adaptation: every non-reset action key becomes either a
  # one-hot (discrete), a discretized grid (opt-in), or a [-1, 1] box.
  for key, space in env.act_space.items():
    if key == 'reset':
      continue
    if space.discrete:
      env = wrappers.OneHotAction(env, key)
    elif spec.discretize:
      env = wrappers.DiscretizeAction(env, key, spec.discretize)
    else:
      env = wrappers.NormalizeAction(env, key)
  if spec.length:
    env = wrappers.TimeLimit(env, spec.length, spec.resets)
  return env


def load_env(
    task, amount=1, parallel='none', daemon=False, restart=False, seed=None,
    kbreset=False, **options):
  ctors = []
  for index in range(amount):
    ctor = functools.partial(load_single_env, task, **options)
    if seed is not None:
      ctor = functools.partial(ctor, seed=hash((seed, index)) % (2 ** 31 - 1))
    if parallel != 'none':
      ctor = functools.partial(core.Parallel, ctor, parallel, daemon)
    if restart:
      ctor = functools.partial(wrappers.RestartOnException, ctor)
    if kbreset:
      from .kbreset import KBReset
      ctor = functools.partial(KBReset, ctor)
    ctors.append(ctor)
  envs = [ctor() for ctor in ctors]
  return core.BatchEnv(envs, parallel=(parallel != 'none'))


__all__ = [
    'load_env', 'load_single_env', 'suite', 'SUITES', 'EnvSpec', 'Dummy',
    'PickPlace', 'EnvConfig', 'RobotType',
]
