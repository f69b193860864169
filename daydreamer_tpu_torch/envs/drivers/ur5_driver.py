"""UR5 hardware driver (reference: embodied/envs/robot_interface.py:36-147).

urx arm control + Robotiq gripper over its socket protocol, exposing the
driver surface the PickPlace ArmController actuates: ``workspace``,
``move_to(x, y, z)``, ``set_gripper``, ``get_state``, ``get_frames``.
Import-gated."""

import socket
import time

import numpy as np

from ..robot import Workspace


class UR5Driver:

  # Two-bin tabletop (reference robot_interface.py:52-65).
  workspace = Workspace(
      left_min=(-0.125, -0.64), left_max=(0.048, -0.36),
      right_min=(-0.455, -0.64), right_max=(-0.285, -0.36),
      z_table=-0.010, z_hover=0.12, axis=0)

  # Fixed top-down tool orientation (axis-angle).
  TOOL_ROT = (2.2214, -2.2214, 0.0)

  def __init__(self, ip='192.168.1.100', gripper_port=63352):
    try:
      import urx
    except ImportError:
      raise ImportError(
          'urx not installed; ur5_real requires the robot host '
          'environment. Use ur5_dummy on the learner.')
    self._arm = urx.Robot(ip)
    self._gripper = _RobotiqGripper(ip, gripper_port)
    from .xarm_driver import _RealSense
    self._camera = _RealSense()

  def move_to(self, x, y, z=None):
    if z is None:
      z = self._arm.getl()[2]
    pose = [x, y, z, *self.TOOL_ROT]
    self._arm.movel(pose, acc=0.5, vel=0.25, wait=True)

  def set_gripper(self, closed):
    self._gripper.move(255 if closed else 0)
    time.sleep(0.3)  # Robotiq has no motion-complete signal over socket.

  def get_state(self):
    pose = np.asarray(self._arm.getl(), np.float32)
    joints = np.asarray(self._arm.getj(), np.float32)
    # Normalized so 0 = fully open, 1 = fully closed.
    gripper = np.asarray([self._gripper.position() / 255.0], np.float32)
    return pose, joints, gripper

  def get_frames(self):
    return self._camera.frames()

  def close(self):
    try:
      self._arm.close()
      self._gripper.close()
    except Exception:
      pass


class _RobotiqGripper:
  """Minimal Robotiq socket protocol client (SET/GET over TCP)."""

  def __init__(self, ip, port):
    self._sock = socket.create_connection((ip, port), timeout=2.0)
    self._set('ACT', 1)
    self._set('GTO', 1)
    self._set('SPE', 255)
    self._set('FOR', 128)
    time.sleep(0.2)

  def _set(self, var, value):
    self._sock.sendall(f'SET {var} {value}\n'.encode())
    self._sock.recv(64)

  def _get(self, var):
    self._sock.sendall(f'GET {var}\n'.encode())
    data = self._sock.recv(64).decode()
    return int(data.split()[-1])

  def move(self, position):
    self._set('POS', int(np.clip(position, 0, 255)))

  def position(self):
    return self._get('POS')

  def close(self):
    self._sock.close()
