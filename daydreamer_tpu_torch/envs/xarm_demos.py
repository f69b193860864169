"""Teleoperated demo collection writing replay-compatible episodes
(reference: embodied/envs/xarm_demos.py).

Drives the PickPlace env with a SpaceMouse (or keyboard fallback) and
stores each finished episode as an npz trajectory that the learner's
DiskStore can ingest directly.

Usage: python -m daydreamer_tpu_torch.envs.xarm_demos --outdir ~/demos
"""

import collections
import time

import numpy as np


def main(argv=None):
  from .. import core
  from ..replay import DiskStore
  from .robot import PickPlace, EnvConfig, RobotType
  parsed = core.Flags(
      outdir='~/demos', robot='xarm', real=False, episodes=10,
  ).parse(argv)
  cfg = EnvConfig(
      use_real=parsed.real,
      robot_type=RobotType(parsed.robot))
  env = PickPlace(cfg)
  store = DiskStore(parsed.outdir)
  try:
    reader = _make_reader()
    for episode in range(parsed.episodes):
      traj = collections.defaultdict(list)
      obs = env.step({'action': 0, 'reset': True})
      while not obs['is_last']:
        action = reader()
        if action is None:
          time.sleep(0.05)
          continue
        obs = env.step({'action': action, 'reset': False})
        for key, value in obs.items():
          traj[key].append(value)
        traj['action'].append(np.int32(action))
      import uuid
      store[uuid.uuid4().hex] = {
          k: core.convert(v) for k, v in traj.items()}
      print(f'Saved demo episode {episode + 1}/{parsed.episodes}.')
  finally:
    env.close()


def _make_reader():
  try:
    from .spacemouse import SpaceMouse
    mouse = SpaceMouse()

    def read():
      state, buttons = mouse.read()
      if buttons[0]:
        return 4  # Toggle gripper.
      if buttons[1]:
        return 5  # Toggle height.
      axis = int(np.argmax(np.abs(state[:2])))
      if abs(state[axis]) < 0.3:
        return None
      if axis == 0:
        return 0 if state[0] > 0 else 1
      return 2 if state[1] > 0 else 3

    return read
  except Exception:
    print('SpaceMouse unavailable; keyboard fallback (w/a/s/d/g/h).')

    def read():
      import sys
      key = sys.stdin.read(1)
      return {'w': 0, 's': 1, 'd': 2, 'a': 3, 'g': 4, 'h': 5}.get(key)

    return read


if __name__ == '__main__':
  main()
