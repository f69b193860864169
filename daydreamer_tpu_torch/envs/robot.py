"""Robot arm pick-and-place environments (XArm / UR5).

Parity with the reference robot env (reference:
embodied/envs/robot_interface.py:279-828). Three operating modes:

- ``*_dummy``: a tiny kinematic simulation stands in for the arm so the
  env produces consistent transitions for tests, pipeline development,
  and the learner half of an async actor/learner pair (reference:
  robot_interface.py:319-322 with train.py:91 closing the env).
- ``*_real``: discrete actions actuate the arm through a hardware driver
  (xarm SDK / urx + RealSense). The ArmController below owns the motion
  logic the reference implements in PickPlace.step/compute_arm_position/
  get_reward (robot_interface.py:603-828): grid-snapped bounded cartesian
  deltas, two-bin workspace with safe interior bounds when carrying,
  gripper toggling with grasp detection from gripper feedback, z-hover
  toggling, and the +1 grasp / -1 drop / +10 transfer shaped reward.
- tests inject a fake driver via ``EnvConfig(driver=...)`` to assert the
  exact command stream without hardware.

Actions (reference robot_interface.py:685-721): 0 -x, 1 +x, 2 -y, 3 +y,
4 toggle gripper, 5 toggle z (when ``enable_z``).
"""

import dataclasses
import enum
import time

import numpy as np

from ..core import base
from ..core import space as spacelib


class RobotType(enum.Enum):
  XARM = 'xarm'
  UR5 = 'ur5'

  def joints(self):
    return {'xarm': 7, 'ur5': 6}[self.value]


class Rate:
  """Fixed-rate sleeper for real-robot control loops (~20 Hz)."""

  def __init__(self, rate_hz):
    self.last = time.time()
    self.rate = rate_hz

  def sleep(self):
    while self.last + 1.0 / self.rate > time.time():
      time.sleep(0.001)
    self.last = time.time()


@dataclasses.dataclass
class Workspace:
  """Two-bin tabletop geometry (reference robot_interface.py:52-65,
  164-178: LEFT/RIGHT_XY_MIN/MAX, SAFE variants, Z levels, divide AXIS)."""

  left_min: tuple
  left_max: tuple
  right_min: tuple
  right_max: tuple
  z_table: float
  z_hover: float
  axis: int = 0           # Coordinate that separates the two bins.
  safe_shrink: tuple = (0.03, 0.03)  # Interior margin for safe bounds.

  def bounds(self, side, safe=False):
    lo, hi = ((self.left_min, self.left_max) if side == 'left'
              else (self.right_min, self.right_max))
    lo, hi = np.array(lo, np.float64), np.array(hi, np.float64)
    if safe:
      lo = lo + self.safe_shrink
      hi = hi - self.safe_shrink
    return lo, hi

  def side_of(self, xy, margin=-0.002):
    """Which bin contains xy, or None (reference arm_side, :552-567)."""
    xy = np.asarray(xy)[:2]
    for side in ('left', 'right'):
      lo, hi = self.bounds(side)
      if (xy >= lo + margin).all() and (xy <= hi - margin).all():
        return side
    return None


def gripper_holding(gripper_pos):
  """Grasp detection from normalized gripper feedback: a gripper stopped
  partway is holding something (reference check_grasped_object_ur:478)."""
  return 0.015 < float(np.asarray(gripper_pos).reshape(-1)[0]) < 0.985


class ArmController:
  """Discrete-action motion logic over a hardware driver.

  The driver supplies: ``workspace`` (Workspace), ``move_to(x, y, z)``,
  ``set_gripper(closed)``, ``get_state() -> (cartesian6, joints, grip01)``,
  ``get_frames()``, ``close()``.
  """

  def __init__(self, driver, max_delta_m=0.04, enable_z=True, seed=None):
    self.driver = driver
    self.ws = driver.workspace
    self.max_delta = float(max_delta_m)
    self.enable_z = enable_z
    self.rng = np.random.default_rng(seed)
    self.gripper_closed = False
    self.holding = False
    self.pick_side = None    # Bin the object was grasped in.
    self.object_side = 'left'

  # -- geometry helpers --

  def _snap(self, xy):
    return np.round(np.asarray(xy) / self.max_delta) * self.max_delta

  def random_bin_xy(self, side):
    """Grid-snapped uniform point inside a bin's safe interior
    (reference random_xy_grid, robot_interface.py:497-531)."""
    lo, hi = self.ws.bounds(side, safe=True)
    xy = self._snap(self.rng.uniform(lo, hi))
    return np.clip(xy, lo, hi)

  def _xyz(self):
    cart, _, _ = self.driver.get_state()
    return np.asarray(cart[:3], np.float64)

  def is_hover(self):
    return self._xyz()[2] > (self.ws.z_hover + self.ws.z_table) / 2

  # -- actions --

  def move_delta(self, dx, dy):
    """Bounded grid move (reference compute_arm_position, :617-674):
    snap the target to the delta grid, clip into the current bin (safe
    interior while hovering), let a carried object cross the divide into
    the far bin's safe interior, hold untouched axes, and pin z to the
    current level."""
    pos = self._xyz()
    hover = self.is_hover()
    side = self.ws.side_of(pos) or self.object_side
    z = self.ws.z_hover if hover else self.ws.z_table
    desired = self._snap(pos[:2] + np.array([dx, dy]) * self.max_delta)
    target = np.clip(desired, *self.ws.bounds(side, safe=hover))
    if self.holding and hover:
      # Crossing the divide while carrying: when the desired point was
      # clipped at the bin edge facing the other bin, jump the target
      # into the far bin's safe interior (reference :648-661).
      axis = self.ws.axis
      other = 'right' if side == 'left' else 'left'
      lo_c, hi_c = self.ws.bounds(side)
      lo_o, hi_o = self.ws.bounds(other)
      toward_other = np.sign(
          (lo_o[axis] + hi_o[axis]) - (lo_c[axis] + hi_c[axis]))
      if (desired[axis] - target[axis]) * toward_other > 0.01:
        target = np.clip(desired, *self.ws.bounds(other, safe=True))
    if dx == 0:
      target[0] = pos[0]
    if dy == 0:
      target[1] = pos[1]
    self.driver.move_to(target[0], target[1], z)

  def toggle_gripper(self):
    self.gripper_closed = not self.gripper_closed
    self.driver.set_gripper(self.gripper_closed)

  def toggle_z(self):
    """Hover/table toggle (reference action 5, :696-721): descend when
    hovering; when at the table holding the object, dip-and-lift within
    safe bounds; otherwise no-op."""
    pos = self._xyz()
    if self.is_hover():
      self.driver.move_to(pos[0], pos[1], self.ws.z_table)
    elif self.holding:
      side = self.ws.side_of(pos) or self.object_side
      xy = np.clip(pos[:2], *self.ws.bounds(side, safe=True))
      self.driver.move_to(xy[0], xy[1], self.ws.z_table)
      self.driver.move_to(xy[0], xy[1], self.ws.z_hover)

  def apply(self, act):
    if act < 4:
      dx, dy = ((-1, 0), (1, 0), (0, -1), (0, 1))[act]
      self.move_delta(dx, dy)
    elif act == 4:
      self.toggle_gripper()
    elif act == 5 and self.enable_z:
      self.toggle_z()
    else:
      raise NotImplementedError(act)

  # -- reward bookkeeping (reference get_reward, :777-828) --

  def update_reward(self):
    _, _, grip = self.driver.get_state()
    was_holding = self.holding
    now_holding = gripper_holding(grip)
    self.holding = now_holding
    pos = self._xyz()
    side = self.ws.side_of(pos)
    if was_holding and now_holding and side and side != self.pick_side:
      # Transfer complete: auto-release over the far bin, settle the
      # object there, and park at a fresh random spot.
      self.gripper_closed = False
      self.driver.set_gripper(False)
      self.holding = False
      self.object_side = side
      self.driver.move_to(pos[0], pos[1], self.ws.z_table)
      xy = self.random_bin_xy(side)
      self.driver.move_to(xy[0], xy[1], self.ws.z_table)
      return 10.0
    if not was_holding and now_holding:
      self.pick_side = side
      if not self.enable_z:
        # Without a z action the grasp auto-lifts (reference :805-819).
        xy = np.clip(pos[:2], *self.ws.bounds(side or self.object_side,
                                              safe=True))
        self.driver.move_to(xy[0], xy[1], self.ws.z_table)
        self.driver.move_to(xy[0], xy[1], self.ws.z_hover)
      return 1.0
    if was_holding and not now_holding:
      self.driver.move_to(pos[0], pos[1], self.ws.z_table)
      self.pick_side = None
      return -1.0
    return 0.0

  def reset_scene(self):
    """Open the gripper and re-seat the object in its bin
    (reference _reset, :737-775)."""
    pos = self._xyz()
    if self.holding:
      xy = self.random_bin_xy(self.object_side)
      self.driver.move_to(xy[0], xy[1], self.ws.z_hover)
    self.gripper_closed = False
    self.driver.set_gripper(False)
    self.holding = False
    self.pick_side = None
    xy = self.random_bin_xy(self.object_side)
    self.driver.move_to(xy[0], xy[1], self.ws.z_table)


@dataclasses.dataclass
class EnvConfig:
  max_delta_m: float = 0.04
  control_rate_hz: float = 20
  with_camera: bool = True
  use_real: bool = False
  robot_type: RobotType = RobotType.XARM
  enable_z: bool = True
  length: int = 100
  driver: object = None   # Injected driver (tests); None = SDK driver.
  seed: int = None


class PickPlace(base.Env):
  """Discrete pick-and-place: -x, +x, -y, +y, toggle gripper, z-toggle.

  In dummy mode a tiny kinematic simulation stands in for the arm so the
  env produces consistent transitions for tests and pipeline development:
  the virtual object is grasped when the gripper closes nearby and a +10
  reward fires on transferring it across the workspace midline, matching
  the reference's shaped reward structure (+1 grasp / -1 drop / +10
  transfer, reference: robot_interface.py:776-828).
  """

  def __init__(self, cfg: EnvConfig):
    self.cfg = cfg
    self._num_actions = 6 if cfg.enable_z else 5
    self._step_count = 0
    self._done = False
    self._ctl = None
    if cfg.use_real or cfg.driver is not None:
      driver = cfg.driver if cfg.driver is not None else self._make_driver()
      self._ctl = ArmController(
          driver, cfg.max_delta_m, cfg.enable_z, seed=cfg.seed)
      self._rate = Rate(cfg.control_rate_hz)
    self._reset_sim()

  def _make_driver(self):
    if self.cfg.robot_type == RobotType.XARM:
      from .drivers.xarm_driver import XArmDriver
      return XArmDriver()
    elif self.cfg.robot_type == RobotType.UR5:
      from .drivers.ur5_driver import UR5Driver
      return UR5Driver()
    raise NotImplementedError(self.cfg.robot_type)

  @property
  def obs_space(self):
    return {
        'image': spacelib.Space(np.uint8, (64, 64, 3)),
        'depth': spacelib.Space(np.uint8, (64, 64, 1)),
        'cartesian_position': spacelib.Space(np.float32, (6,)),
        'joint_positions': spacelib.Space(
            np.float32, (self.cfg.robot_type.joints(),)),
        'gripper_pos': spacelib.Space(np.float32, (1,)),
        'gripper_side': spacelib.Space(np.float32, (3,)),
        'grasped_side': spacelib.Space(np.float32, (3,)),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @property
  def act_space(self):
    return {
        'action': spacelib.Space(np.int32, (), 0, self._num_actions),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      self._step_count = 0
      self._done = False
      if self._ctl is not None:
        self._ctl.reset_scene()
      self._reset_sim()
      return self._obs(0.0, is_first=True)
    act = int(action['action'])
    if self._ctl is not None:
      self._ctl.apply(act)
      self._rate.sleep()
      reward = self._ctl.update_reward()
    else:
      reward = self._apply_sim(act)
    self._step_count += 1
    if self.cfg.length:
      self._done = self._step_count >= self.cfg.length
    return self._obs(reward, is_last=self._done, is_terminal=False)

  def close(self):
    if self._ctl is not None:
      self._ctl.driver.close()

  # -- tiny kinematic stand-in ------------------------------------------------

  def _reset_sim(self):
    self._pos = np.zeros(2, np.float32)  # gripper xy on [-1, 1] grid
    self._grip = 0.0
    self._hover = True
    self._obj = np.array([0.5, 0.0], np.float32)
    self._grasped = False
    self._obj_side = 1.0  # +1 right, -1 left

  def _apply_sim(self, act):
    delta = self.cfg.max_delta_m / 0.04 * 0.1
    reward = 0.0
    if act < 4:  # Reference delta order: -x, +x, -y, +y.
      dx, dy = ((-1, 0), (1, 0), (0, -1), (0, 1))[act]
      self._pos[0] = np.clip(self._pos[0] + dx * delta, -1.0, 1.0)
      self._pos[1] = np.clip(self._pos[1] + dy * delta, -1.0, 1.0)
    elif act == 4:  # Toggle gripper.
      self._grip = 1.0 - self._grip
      near = np.linalg.norm(self._pos - self._obj) < 0.15
      if self._grip and near and not self._grasped:
        self._grasped = True
        reward += 1.0
      elif not self._grip and self._grasped:
        self._grasped = False
        side = 1.0 if self._pos[0] > 0 else -1.0
        if side != self._obj_side:
          reward += 10.0
          self._obj_side = side
        else:
          reward -= 1.0
        self._obj = self._pos.copy()
    elif act == 5:  # Toggle hover height.
      self._hover = not self._hover
    if self._grasped:
      self._obj = self._pos.copy()
    return reward

  def _obs(self, reward, is_first=False, is_last=False, is_terminal=False):
    if self._ctl is not None:
      image, depth = self._ctl.driver.get_frames()
      cartesian, joints, gripper = self._ctl.driver.get_state()
      on_right = self._ctl.ws.side_of(cartesian[:2]) == 'right'
      holding, obj_side = self._ctl.holding, self._ctl.object_side
      grasped_idx = 2 if not holding else (0 if obj_side == 'right' else 1)
    else:
      image = np.zeros((64, 64, 3), np.uint8)
      depth = np.zeros((64, 64, 1), np.uint8)
      # Render gripper and object as blobs comparable in size to real
      # camera footage (a 1-pixel marker is below what a 64x64 conv
      # decoder can track through an MSE loss).
      gx, gy = ((self._pos + 1) / 2 * 63).astype(int)
      ox, oy = ((self._obj + 1) / 2 * 63).astype(int)

      def blob(cy, cx, color, radius=3):
        y0, y1 = max(cy - radius, 0), min(cy + radius + 1, 64)
        x0, x1 = max(cx - radius, 0), min(cx + radius + 1, 64)
        image[y0:y1, x0:x1] = color
        depth[y0:y1, x0:x1] = 128

      blob(oy, ox, (0, 255, 0))
      blob(gy, gx, (255, 0, 0) if not self._grip else (255, 255, 0))
      cartesian = np.concatenate(
          [self._pos, [0.1 if self._hover else 0.0], np.zeros(3)]
      ).astype(np.float32)
      joints = np.zeros(self.cfg.robot_type.joints(), np.float32)
      gripper = np.array([self._grip], np.float32)
      on_right = self._pos[0] > 0
      grasped_idx = 2 if not self._grasped else (0 if self._obj_side > 0
                                                 else 1)
    side = np.zeros(3, np.float32)
    side[0 if on_right else 1] = 1.0
    grasped_side = np.zeros(3, np.float32)
    grasped_side[grasped_idx] = 1.0
    return dict(
        image=image,
        depth=depth,
        cartesian_position=np.asarray(cartesian, np.float32),
        joint_positions=np.asarray(joints, np.float32),
        gripper_pos=np.asarray(gripper, np.float32),
        gripper_side=side,
        grasped_side=grasped_side,
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_terminal,
    )
