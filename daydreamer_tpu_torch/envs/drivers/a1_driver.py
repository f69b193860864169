"""Real Unitree A1 driver over the native UDP robot interface.

Python-side counterpart of the reference's A1Robot
(reference: motion_imitation/robots/a1_robot.py + the pybind11
robot_interface): reads low state at the control rate, runs a velocity
estimator, maps normalized policy actions to PD position targets around the
standing pose (reference: robots/a1.py:130-156), and performs a slow
interpolated stand-up on reset (reference: minitaur.py:421-448
_SafeJointsReset). All hard safety clamping happens in C++
(native/robot_interface.cpp) before commands reach the wire.
"""

import ctypes
import time

import numpy as np

from ...native import load

STANDING_POSE = np.array([0.0, 0.9, -1.8] * 4, np.float32)
ACTION_OFFSET = 0.6  # Radians around the standing pose per action unit.
KP, KD = 60.0, 0.8
CONTROL_RATE_HZ = 20.0
OBS_FLOATS = 50


class A1Driver:

  obs_dim = OBS_FLOATS + 3  # Raw low state + estimated base velocity.

  def __init__(self, robot_ip='192.168.123.10', local_port=8090,
               remote_port=8007, timeout_ms=100, wire='vendor'):
    """wire: 'vendor' speaks the Unitree SDK's byte-exact LowCmd/LowState
    UDP packets (drives a real A1 directly); 'framework' uses the compact
    packet understood by the loopback simulator/bridge."""
    self._lib = load('robot_interface')
    wire_mode = {'framework': 0, 'vendor': 1}[wire]
    self._handle = self._lib.a1_create_wire(
        robot_ip.encode(), local_port, remote_port, timeout_ms, wire_mode)
    if not self._handle:
      raise RuntimeError('Could not create A1 UDP endpoint.')
    self._obs_buf = (ctypes.c_float * OBS_FLOATS)()
    self._cmd_buf = (ctypes.c_float * 60)()
    self._velocity = np.zeros(3, np.float32)
    self._last_time = time.time()

  def close(self):
    if self._handle:
      self._lib.a1_destroy(self._handle)
      self._handle = None

  def reset(self):
    """Slow interpolated stand-up to the standing pose (~2 seconds)."""
    state = self._receive()
    current = state[:12].copy()
    steps = int(2.0 * CONTROL_RATE_HZ)
    for i in range(steps):
      alpha = (i + 1) / steps
      target = (1 - alpha) * current + alpha * STANDING_POSE
      self._send_pd(target)
      time.sleep(1.0 / CONTROL_RATE_HZ)
      state = self._receive()
    return self._observe(state)

  def apply(self, action, repeat=1):
    """Apply a normalized 12-dim action for `repeat` control steps."""
    target = STANDING_POSE + ACTION_OFFSET * np.clip(action, -1, 1)
    reward = 0.0
    state = None
    for _ in range(max(1, repeat)):
      self._send_pd(target)
      state = self._receive()
      reward += self._reward(state)
      time.sleep(max(0.0, 1.0 / CONTROL_RATE_HZ - 0.001))
    return self._observe(state), reward / max(1, repeat)

  # -- internals --------------------------------------------------------------

  def _send_pd(self, target_positions):
    cmd = np.zeros((12, 5), np.float32)
    cmd[:, 0] = target_positions
    cmd[:, 2] = KP
    cmd[:, 3] = KD
    flat = cmd.reshape(-1)
    ctypes.memmove(self._cmd_buf, flat.ctypes.data, 60 * 4)
    self._lib.a1_send_command(self._handle, self._cmd_buf)

  def _receive(self):
    for _ in range(50):
      ret = self._lib.a1_receive_observation(self._handle, self._obs_buf)
      if ret == 1:
        return np.ctypeslib.as_array(self._obs_buf).copy()
    raise TimeoutError('No observation from robot.')

  def _reward(self, state):
    """Stand+walk shaping from on-board state (RMA-style, reference:
    motion_imitation/envs/env_wrappers/rma_task.py:6-56)."""
    quat = state[36:40]
    upright = 1.0 - 2.0 * (quat[1] ** 2 + quat[2] ** 2)  # R[2,2].
    r_upr = float(np.clip(upright, 0.0, 1.0))
    qpos = state[:12] - STANDING_POSE
    r_pose = float(np.exp(-0.5 * np.sum(qpos ** 2)))
    r_vel = float(np.clip(self._velocity[0] / 0.5, -1.0, 1.0))
    return (r_upr + r_pose + 10.0 * (r_vel + 1.0) / 2.0) / 12.0

  def _observe(self, state):
    # Complementary-filter velocity estimate: integrate body acceleration
    # with decay (stand-in for the reference's Kalman estimator,
    # reference: robots/a1_robot_velocity_estimator.py:7-113).
    now = time.time()
    dt = min(0.1, now - self._last_time)
    self._last_time = now
    accel = state[43:46]
    self._velocity = 0.95 * (self._velocity + accel * dt)
    return np.concatenate([state, self._velocity]).astype(np.float32)

  def stats(self):
    sent = ctypes.c_uint64()
    received = ctypes.c_uint64()
    clamped = ctypes.c_uint64()
    self._lib.a1_stats(
        self._handle, ctypes.byref(sent), ctypes.byref(received),
        ctypes.byref(clamped))
    return dict(sent=sent.value, received=received.value,
                clamped=clamped.value)
