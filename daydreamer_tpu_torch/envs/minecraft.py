"""Minecraft (MineRL) adapter (reference: embodied/envs/minecraft.py:10-197
and minerl_internal.py via envs/minerl_tasks.py). Import-gated on minerl.

Capabilities at parity with the reference:
- per-task discrete action vocabularies (wood/table/axe/diamond/discover)
  over the MineRL low-level action dict (minerl_tasks.ACTIONS);
- sticky attack / sticky jump and camera pitch clamping (ActionSmoother,
  testable without minerl);
- observations: pov image, log-scaled inventory vector, one-hot equipped
  item, per-item `log_inventory/*` counters, `new_items` discovery count;
- `discover` task rewards newly collected item types instead of the env
  reward;
- action repeat holds movement keys but fires crafting/placement once.
"""

import functools
import threading

import numpy as np

from ..core import base
from ..core import space as spacelib
from . import minerl_tasks


class ActionSmoother:
  """Sticky attack/jump and pitch clamping on MineRL low-level actions.

  Mirrors the reference's control shaping (embodied/envs/minecraft.py:
  160-180): an attack press holds attack for `sticky_attack` steps
  (suppressing jump), a jump press holds jump+forward for `sticky_jump`
  steps, and camera pitch is clamped to `pitch_limit` degrees by zeroing
  out-of-range pitch deltas. Pure Python; unit-tested without minerl.
  """

  def __init__(self, sticky_attack=30, sticky_jump=10,
               pitch_limit=(-60, 60)):
    self._sticky_attack = sticky_attack
    self._sticky_jump = sticky_jump
    self._pitch_limit = pitch_limit
    self.reset()

  def reset(self):
    self._attack_left = 0
    self._jump_left = 0
    self._pitch = 0

  def __call__(self, action):
    action = dict(action)
    if self._sticky_attack:
      if action['attack']:
        self._attack_left = self._sticky_attack
      if self._attack_left > 0:
        action['attack'] = 1
        action['jump'] = 0
        self._attack_left -= 1
    if self._sticky_jump:
      if action['jump']:
        self._jump_left = self._sticky_jump
      if self._jump_left > 0:
        action['jump'] = 1
        action['forward'] = 1
        self._jump_left -= 1
    dpitch = action['camera'][0]
    if self._pitch_limit and dpitch:
      lo, hi = self._pitch_limit
      if not (lo <= self._pitch + dpitch <= hi):
        action['camera'] = (0, action['camera'][1])
      else:
        self._pitch += dpitch
    return action


class Minecraft(base.Env):

  _LOCK = threading.Lock()  # MineRL's Malmo launcher is not thread-safe.

  def __init__(self, task, repeat=1, size=(64, 64), length=24000,
               sticky_attack=30, sticky_jump=10, pitch_limit=(-60, 60)):
    import gym as openai_gym
    self._task = task
    self._repeat = repeat
    self._size = tuple(size)
    self._length = length
    with self._LOCK:
      eid = minerl_tasks.register(task, self._size)
      self._env = openai_gym.make(eid)
    table = minerl_tasks.full_actions(task)
    self._action_names = tuple(table.keys())
    self._action_values = tuple(table.values())
    print(f'Minecraft action space ({len(self._action_values)}):',
          ', '.join(self._action_names))
    self._smoother = ActionSmoother(sticky_attack, sticky_jump, pitch_limit)
    self._inv_keys = sorted(
        k for k in self._env.observation_space.spaces['inventory'].spaces)
    self._equip_enum = list(
        self._env.observation_space['equipped_items']['mainhand']['type']
        .values)
    self._collected = set()
    self._step = 0
    self._done = True

  @functools.cached_property
  def obs_space(self):
    return {
        'image': spacelib.Space(np.uint8, self._size + (3,)),
        'inventory': spacelib.Space(np.float32, len(self._inv_keys), 0),
        'equipped': spacelib.Space(
            np.float32, len(self._equip_enum), 0, 1),
        **{f'log_inventory/{k}': spacelib.Space(np.int32)
           for k in self._inv_keys},
        'reward': spacelib.Space(np.float32),
        'new_items': spacelib.Space(np.int32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @functools.cached_property
  def act_space(self):
    return {
        'action': spacelib.Space(np.int32, (), 0, len(self._action_values)),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      return self._reset()
    act = self._smoother(self._action_values[int(action['action'])])
    # Repeated frames keep only the held movement keys so one-shot actions
    # (craft/place/equip) fire exactly once per env step.
    held = dict(minerl_tasks.NOOP)
    for key in ('attack', 'forward', 'back', 'left', 'right'):
      held[key] = act[key]
    reward, done = 0.0, False
    obs = None
    for i in range(self._repeat):
      obs, rew, done, _ = self._env.step(act if i == 0 else held)
      reward += rew
      self._step += 1
      if done:
        break
    new_items = self._discoveries(obs)
    if self._task == 'discover':
      reward = float(new_items)
    self._done = done or self._step >= self._length
    return self._obs(obs, reward, new_items,
                     is_last=self._done, is_terminal=done)

  def _reset(self):
    with self._LOCK:
      obs = self._env.reset()
    self._done = False
    self._step = 0
    self._collected.clear()
    self._smoother.reset()
    new_items = self._discoveries(obs)
    return self._obs(obs, 0.0, new_items, is_first=True)

  def _discoveries(self, obs):
    new = 0
    for key in self._inv_keys:
      if key == 'air' or key in self._collected:
        continue
      if int(np.asarray(obs['inventory'][key]).item()) > 0:
        new += 1
        self._collected.add(key)
    return new

  def _obs(self, obs, reward, new_items, is_first=False, is_last=False,
           is_terminal=False):
    counts = np.array(
        [np.asarray(obs['inventory'][k]).item() for k in self._inv_keys],
        np.float32)
    equipped = np.zeros(len(self._equip_enum), np.float32)
    kind = obs['equipped_items']['mainhand']['type']
    if not isinstance(kind, str):
      kind = self._equip_enum[int(kind)]
    equipped[self._equip_enum.index(kind)] = 1.0
    return {
        'image': np.asarray(obs['pov'], np.uint8),
        'inventory': np.log1p(counts),
        'equipped': equipped,
        **{f'log_inventory/{k}': np.int32(c)
           for k, c in zip(self._inv_keys, counts)},
        'reward': np.float32(reward),
        'new_items': np.int32(new_items),
        'is_first': is_first,
        'is_last': is_last,
        'is_terminal': is_terminal,
    }
