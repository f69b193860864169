"""dm_control locomotion maze navigation (reference: embodied/envs/loconav.py:10-115)."""

import functools
import os

import numpy as np

from ..core import base
from ..core import space as spacelib


class LocoNav(base.Env):

  DEFAULT_CAMERAS = dict(ant=1, quadruped=2)

  def __init__(self, task, repeat=1, size=(64, 64), camera=-1, again=False,
               episodic=True):
    os.environ.setdefault('MUJOCO_GL', 'egl')
    agent, maze = task.split('_', 1)
    if camera == -1:
      camera = self.DEFAULT_CAMERAS.get(agent, 0)
    from dm_control import composer
    from dm_control.locomotion import arenas, tasks, walkers
    if agent == 'ant':
      walker = walkers.Ant()
    elif agent == 'quadruped':
      walker = walkers.JumpingBallWithHead()
    else:
      raise NotImplementedError(agent)
    arena = arenas.MazeWithTargets(
        maze=_labmaze(maze), xy_scale=1.2, z_height=2.0)
    task = tasks.NullGoalMaze(
        walker=walker, maze_arena=arena, randomize_spawn_rotation=True,
        contact_termination=False, physics_timestep=0.005,
        control_timestep=0.03)
    env = composer.Environment(
        task=task, random_state=np.random.RandomState(0),
        strip_singleton_obs_buffer_dim=True)
    from . import dmc
    self._dmenv = env
    self._env = dmc.FromDM(env)
    from ..core import wrappers
    self._env = wrappers.ActionRepeat(self._env, repeat)
    self._size = size
    self._camera = camera

  @functools.cached_property
  def obs_space(self):
    spaces = dict(self._env.obs_space)
    spaces['image'] = spacelib.Space(np.uint8, self._size + (3,))
    return spaces

  @functools.cached_property
  def act_space(self):
    return self._env.act_space

  def step(self, action):
    obs = self._env.step(action)
    obs['image'] = self.render()
    return obs

  def render(self):
    return self._dmenv.physics.render(
        *self._size, camera_id=self._camera)


def _labmaze(name):
  import labmaze
  return labmaze.RandomMaze(
      height=11, width=11, max_rooms=4, room_min_size=3, room_max_size=5,
      spawns_per_room=1, objects_per_room=1, random_seed=0)
