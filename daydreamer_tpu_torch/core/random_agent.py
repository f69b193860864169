"""Uniform-sample prefill policy (reference: embodied/core/random.py:4-14)."""

import numpy as np

from . import base


class RandomAgent(base.Agent):

  def __init__(self, act_space):
    self.act_space = act_space['action']

  def policy(self, obs, state=None, mode='train'):
    batch_size = len(obs['is_first'])
    act = {
        'action': np.stack([
            self.act_space.sample() for _ in range(batch_size)])}
    return act, state
