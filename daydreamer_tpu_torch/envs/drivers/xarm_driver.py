"""XArm hardware driver (reference: embodied/envs/robot_interface.py:150-276).

Thin host-side wrapper over the vendor xarm SDK with RealSense frames,
including the reference's error-clearing retry loops. Exposes the driver
surface the PickPlace ArmController actuates: ``workspace``,
``move_to(x, y, z)`` (meters; the SDK speaks millimeters), ``set_gripper``,
``get_state``, ``get_frames``. Import-gated: raises a clear error when the
SDK is absent (e.g. on the learner host)."""

import time

import numpy as np

from ..robot import Workspace

GRIPPER_OPEN = 850
GRIPPER_CLOSE = 0
VEL_MM_S = 200


class XArmDriver:

  # Two-bin tabletop (reference robot_interface.py:164-178).
  workspace = Workspace(
      left_min=(0.252, 0.085), left_max=(0.523, 0.175),
      right_min=(0.252, -0.170), right_max=(0.523, -0.075),
      z_table=0.182, z_hover=0.290, axis=1)

  def __init__(self, ip='192.168.1.208'):
    try:
      from xarm.wrapper import XArmAPI
    except ImportError:
      raise ImportError(
          'xarm SDK not installed; xarm_real requires the robot host '
          'environment. Use xarm_dummy on the learner.')
    self._arm = XArmAPI(ip)
    self._clear_errors()
    self._arm.motion_enable(True)
    self._arm.set_mode(0)
    self._arm.set_state(0)
    self._arm.set_gripper_enable(True)
    self._camera = _RealSense()

  def _clear_errors(self, attempts=10):
    for _ in range(attempts):
      if not self._arm.has_err_warn:
        return
      self._arm.clean_error()
      self._arm.clean_warn()
      self._arm.motion_enable(True)
      self._arm.set_mode(0)
      self._arm.set_state(0)
      time.sleep(0.1)

  def _wait_settled(self):
    while self._arm.get_is_moving():
      time.sleep(0.01)

  def move_to(self, x, y, z=None):
    """Cartesian move in meters with the fixed top-down orientation."""
    self._clear_errors()
    self._arm.set_position(
        x=1000 * x, y=1000 * y, z=None if z is None else 1000 * z,
        roll=-180, pitch=0, yaw=0, speed=VEL_MM_S, wait=True)
    self._wait_settled()

  def set_gripper(self, closed):
    self._clear_errors()
    self._arm.set_gripper_position(
        GRIPPER_CLOSE if closed else GRIPPER_OPEN, wait=True)
    self._wait_settled()

  def get_state(self):
    self._wait_settled()
    code, pose = self._arm.get_position(is_radian=True)
    code, joints = self._arm.get_servo_angle(is_radian=True)
    code, gripper = self._arm.get_gripper_position()
    pose = np.asarray(pose[:6], np.float32)
    pose[:3] /= 1000  # mm -> m.
    grip = (gripper - GRIPPER_OPEN) / (GRIPPER_CLOSE - GRIPPER_OPEN)
    return (pose,
            np.asarray(joints[:7], np.float32),
            np.asarray([grip], np.float32))

  def get_frames(self):
    return self._camera.frames()

  def close(self):
    try:
      self._arm.disconnect()
    except Exception:
      pass


class _RealSense:
  """RGB + depth capture, cropped/normalized to 64x64
  (reference: robot_interface.py:358-389)."""

  def __init__(self):
    try:
      import pyrealsense2 as rs
    except ImportError:
      self._pipeline = None
      return
    import cv2
    self._rs = rs
    self._cv2 = cv2
    ctx = rs.context()
    for dev in ctx.query_devices():
      dev.hardware_reset()
    time.sleep(2)
    self._pipeline = rs.pipeline()
    config = rs.config()
    config.enable_stream(rs.stream.depth, 640, 480, rs.format.z16, 30)
    config.enable_stream(rs.stream.color, 640, 480, rs.format.bgr8, 30)
    self._pipeline.start(config)

  def frames(self):
    if self._pipeline is None:
      return (np.zeros((64, 64, 3), np.uint8),
              np.zeros((64, 64, 1), np.uint8))
    frames = self._pipeline.wait_for_frames()
    color = np.asanyarray(frames.get_color_frame().get_data())
    depth = np.asanyarray(frames.get_depth_frame().get_data())
    depth = self._cv2.convertScaleAbs(depth, alpha=0.03)
    image = self._cv2.resize(color, (64, 64))[:, :, ::-1]
    depth = self._cv2.resize(depth, (64, 64))[:, :, None]
    depth = depth.astype(np.float32) / 255
    nearest, farthest = 0.050, 0.120
    depth = (depth - nearest) / (farthest - nearest)
    depth = (255 * np.clip(depth, 0, 1)).astype(np.uint8)
    return image.astype(np.uint8), depth
