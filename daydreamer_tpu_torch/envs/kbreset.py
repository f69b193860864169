"""Keyboard pause/resume/reset overlay for real-robot training
(reference: embodied/envs/kbreset.py:16-103).

A pygame window listens for P (pause), C (continue), R (hard reset).
Pausing injects is_last so the agent treats the boundary correctly; resume
issues a manual_resume step with is_first; hard reset rebuilds the env.
"""

import numpy as np

from ..core import base


class KBReset(base.Wrapper):

  SIZE = (240, 120)

  def __init__(self, ctor):
    self._ctor = ctor
    super().__init__(ctor())
    import pygame
    self._pygame = pygame
    pygame.init()
    self._screen = pygame.display.set_mode(self.SIZE)
    pygame.display.set_caption('KBReset: [P]ause [C]ontinue [R]eset')
    self._paused = False
    self._pending_resume = False
    self._fill('green')

  def step(self, action):
    keys = self._get_keys()
    if 'r' in keys:
      print('KBReset: hard reset.')
      self._fill('red')
      try:
        self.env.close()
      except Exception:
        pass
      self.env = self._ctor()
      self._paused = False
      self._fill('green')
      return self.env.step({**action, 'reset': True})
    if self._paused:
      if 'c' in keys:
        print('KBReset: continue.')
        self._paused = False
        self._fill('green')
        obs = self.env.step({**action, 'reset': True,
                             'manual_resume': True})
        obs['is_first'] = True
        return obs
      return self._pause_obs()
    if 'p' in keys:
      print('KBReset: pause.')
      self._paused = True
      self._fill('yellow')
      return self._pause_obs()
    return self.env.step(action)

  def _pause_obs(self):
    obs = {
        k: np.zeros(v.shape, v.dtype)
        for k, v in self.env.obs_space.items()}
    obs['is_last'] = True
    obs['reward'] = np.float32(0.0)
    return obs

  def _get_keys(self):
    pygame = self._pygame
    keys = []
    for event in pygame.event.get():
      if event.type == pygame.KEYDOWN:
        keys.append(pygame.key.name(event.key))
    return keys

  def _fill(self, color):
    self._screen.fill(color)
    self._pygame.display.flip()
