"""Environment registry and assembly.

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
from .a1 import A1
from .robot import PickPlace, EnvConfig, RobotType
from .sphero import SpheroEnv

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


@suite('gym')
def _gym(task, spec):
  from .gym import Gym
  return Gym(task)


@suite('a1')
def _a1(task, spec):
  # `render` gates the per-step 64x64 camera render: software EGL costs
  # ~45ms/frame, dominating proprio-only training where the image is
  # never encoded (a1 config uses cnn_keys '$^').
  return A1(task, spec.repeat, spec.length or 1000, spec.render, spec.size,
            seed=spec.seed, sensor_latency=spec.sensor_latency)


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


@suite('sphero')
def _sphero(task, spec):
  from .sphero import EnvConfig as SpheroConfig
  assert task in ('real', 'dummy')
  return SpheroEnv(SpheroConfig(
      use_real=(task == 'real'), length=spec.length or 100))


@suite('dmc')
def _dmc(task, spec):
  from .dmc import DMC
  return DMC(task, spec.repeat, spec.size, spec.camera, spec.render)


@suite('atari')
def _atari(task, spec):
  from .atari import Atari
  return Atari(task, spec.repeat, spec.size, spec.gray,
               lives=spec.lives, sticky=spec.sticky)


@suite('crafter')
def _crafter(task, spec):
  from .crafter import Crafter
  assert spec.repeat == 1
  outdir = core.Path(spec.logdir) / 'crafter' if spec.mode == 'train' else None
  return Crafter(task, spec.size, outdir)


@suite('dmlab')
def _dmlab(task, spec):
  from .dmlab import DMLab
  return DMLab(task, spec.repeat, spec.size, spec.mode,
               seed=spec.seed, episodic=spec.episodic)


@suite('minecraft')
def _minecraft(task, spec):
  from .minecraft import Minecraft
  return Minecraft(task, spec.repeat, spec.size)


@suite('loconav')
def _loconav(task, spec):
  from .loconav import LocoNav
  return LocoNav(task, spec.repeat, spec.size, spec.camera)


@suite('hrlgrid')
def _hrlgrid(task, spec):
  from .hrlgrid import HRLGrid
  assert spec.repeat == 1
  return HRLGrid(int(task), spec.length or 1000)


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
    'A1', 'PickPlace', 'EnvConfig', 'RobotType', 'SpheroEnv',
]
