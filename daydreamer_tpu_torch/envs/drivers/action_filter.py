"""Low-pass action filters for smooth real-robot motion
(reference: motion_imitation/robots/action_filter.py:46-248).

ActionFilterButter: digital Butterworth low-pass (2nd order by default)
applied per action dimension at the control rate. ActionFilterExp: simple
exponential moving average. Both operate sample-by-sample with internal
state, matching the hardware control-loop usage.
"""

import numpy as np


class ActionFilterButter:

  def __init__(self, sampling_rate=20.0, highcut=4.0, order=2, dims=12):
    self.order = order
    self.dims = dims
    self.b, self.a = self._butter_lowpass(highcut, sampling_rate, order)
    # Direct-form II transposed state per dimension.
    self.z = np.zeros((max(len(self.a), len(self.b)) - 1, dims))
    self._initialized = False

  def _butter_lowpass(self, highcut, fs, order):
    # Bilinear-transform Butterworth design (no scipy dependency).
    nyq = 0.5 * fs
    normal_cutoff = highcut / nyq
    # Pre-warped analog cutoff.
    warped = np.tan(np.pi * normal_cutoff / 2.0)
    if order == 1:
      b0 = warped / (1 + warped)
      b = np.array([b0, b0])
      a = np.array([1.0, (warped - 1) / (warped + 1)])
      return b, a
    assert order == 2, order
    # Analog prototype: H(s) = 1 / (s^2 + sqrt(2) s + 1), s -> s/wc.
    k = warped
    sq2 = np.sqrt(2.0)
    norm = 1 + sq2 * k + k * k
    b = np.array([k * k, 2 * k * k, k * k]) / norm
    a = np.array([1.0, 2 * (k * k - 1) / norm, (1 - sq2 * k + k * k) / norm])
    return b, a

  def init_history(self, action):
    """Prime the filter so the first output equals the given action."""
    action = np.asarray(action, np.float64)
    # Steady-state of DF2T for constant input u: output = u.
    for _ in range(4 * len(self.b)):
      self.filter(action)
    self._initialized = True

  def filter(self, action):
    action = np.asarray(action, np.float64)
    b, a, z = self.b, self.a, self.z
    out = b[0] * action + z[0]
    for i in range(len(z) - 1):
      z[i] = b[i + 1] * action + z[i + 1] - a[i + 1] * out
    z[-1] = b[len(z)] * action - a[len(z)] * out
    return out

  def reset(self):
    self.z[:] = 0.0
    self._initialized = False


class ActionFilterExp:

  def __init__(self, alpha=0.9, dims=12):
    self.alpha = alpha
    self.dims = dims
    self.state = None

  def init_history(self, action):
    self.state = np.asarray(action, np.float64).copy()

  def filter(self, action):
    action = np.asarray(action, np.float64)
    if self.state is None:
      self.state = action.copy()
    self.state = self.alpha * self.state + (1 - self.alpha) * action
    return self.state.copy()

  def reset(self):
    self.state = None
