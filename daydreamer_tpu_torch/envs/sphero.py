"""Sphero rolling-robot navigation env (reference: embodied/envs/sphero.py:40-330).

Structure:

- ``BallTracker``: HSV-threshold segmentation of the overhead camera frame
  into a normalized arena position (reference: get_ball_pos,
  sphero.py:170-201) — Gaussian blur, inRange mask, erode/dilate, and a
  mask-weighted centroid. Thresholds are calibrated with
  ``envs/hsv_finder.py``.
- ``SpheroEnv``: goal-conditioned navigation with reward = -distance from
  the tracked ball to the goal (both normalized to [0, 1]^2 arena
  coordinates) and ``log_success`` within SUCCESS_THRESHOLD.
- Real mode drives the ball's raw motors through the spherov2 SDK and
  reads a RealSense overhead camera (both gated behind imports; reference:
  sphero.py:57-76, 243-252).
- Dummy mode simulates ball dynamics (velocity damping) and RENDERS the
  ball into a synthetic overhead frame, so the perception path — tracker
  included — is exercised end-to-end without hardware.
"""

import dataclasses
import time

import numpy as np

from ..core import base
from ..core import space as spacelib


class Rate:

  def __init__(self, rate_hz):
    self.last = time.time()
    self.rate = rate_hz

  def sleep(self):
    while self.last + 1.0 / self.rate > time.time():
      time.sleep(0.001)
    self.last = time.time()


class BallTracker:
  """HSV segmentation -> normalized arena position (reference
  sphero.py:170-201). Returns (pos01, mask, found); keeps the last seen
  position when the ball disappears from view."""

  def __init__(self, low_hsv, high_hsv, arena_min, arena_max):
    self.low = np.asarray(low_hsv, np.uint8)
    self.high = np.asarray(high_hsv, np.uint8)
    self.arena_min = np.asarray(arena_min, np.float64)
    self.arena_max = np.asarray(arena_max, np.float64)
    self.last_pos = None

  def __call__(self, image_bgr):
    import cv2
    blurred = cv2.GaussianBlur(image_bgr, (15, 15), 0)
    hsv = cv2.cvtColor(blurred, cv2.COLOR_BGR2HSV)
    mask = cv2.inRange(hsv, self.low, self.high)
    mask = cv2.erode(mask, None, iterations=2)
    mask = cv2.dilate(mask, None, iterations=2)
    if not mask.any():
      return self.last_pos, mask, False
    h, w = mask.shape
    cols = mask.mean(0)
    rows = mask.mean(1)
    x = float(np.dot(np.arange(w), cols / cols.sum()))
    y = float(np.dot(np.arange(h), rows / rows.sum()))
    pos = (np.array([x, y]) - self.arena_min) / (
        self.arena_max - self.arena_min)
    self.last_pos = pos
    return pos, mask, True


@dataclasses.dataclass
class EnvConfig:
  use_real: bool = False
  length: int = 100
  control_rate_hz: float = 2.0
  max_control: int = 70          # Raw motor command bound (0..255).
  goal: tuple = (0.825, 0.165)   # Reference GOAL_POS (sphero.py:48).
  low_hsv: tuple = (94, 87, 83)       # Reference LOW_WHITE_THRESH.
  high_hsv: tuple = (129, 255, 171)   # Reference HIGH_WHITE_THRESH.
  arena_min: tuple = (193, 67)   # Camera-pixel arena corners.
  arena_max: tuple = (480, 370)
  seed: int = None


SUCCESS_THRESHOLD = 0.1


class SpheroEnv(base.Env):

  def __init__(self, cfg: EnvConfig):
    self.cfg = cfg
    self._step_count = 0
    self._done = False
    self._rng = np.random.default_rng(cfg.seed)
    self._goal = np.asarray(cfg.goal, np.float32)
    if cfg.use_real:
      from spherov2 import scanner
      from spherov2.sphero_edu import SpheroEduAPI
      self._toy = scanner.find_toy()
      self._api = SpheroEduAPI(self._toy).__enter__()
      self._api.set_stabilization(False)
      self._camera = _RealSenseCamera()
      self._tracker = BallTracker(
          cfg.low_hsv, cfg.high_hsv, cfg.arena_min, cfg.arena_max)
      self._rate = Rate(cfg.control_rate_hz)
    else:
      self._api = None
      self._camera = _SimCamera(self._rng, cfg.arena_min, cfg.arena_max)
      # The sim camera renders a bright ball on a dark arena at the real
      # camera resolution; track it with a permissive white threshold but
      # the SAME arena geometry as the real setup.
      self._tracker = BallTracker(
          (0, 0, 160), (180, 80, 255), cfg.arena_min, cfg.arena_max)
      self._rate = None

  @property
  def obs_space(self):
    return {
        'image': spacelib.Space(np.uint8, (64, 64, 3)),
        'goal': spacelib.Space(np.float32, (2,)),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
        'log_success': spacelib.Space(np.uint8),
    }

  @property
  def act_space(self):
    return {
        'action': spacelib.Space(np.float32, (2,), -1.0, 1.0),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      return self._reset()
    act = np.clip(np.asarray(action['action'], np.float32), -1, 1)
    if self._api is not None:
      self._api.raw_motor(
          int(act[0] * self.cfg.max_control),
          int(act[1] * self.cfg.max_control),
          duration=1.0 / self.cfg.control_rate_hz)
      self._rate.sleep()
    else:
      self._camera.push(act)
    self._step_count += 1
    if self.cfg.length:
      self._done = self._step_count >= self.cfg.length
    return self._obs(is_last=self._done)

  def _reset(self):
    self._step_count = 0
    self._done = False
    if self._api is not None:
      # Wait for a human to return the ball, then scramble its position
      # (reference _reset, sphero.py:257-274).
      while not self._tracker(self._camera.color())[2]:
        print('Waiting for you to put the ball into the arena...')
        time.sleep(1)
      for _ in range(5):
        direction = self._rng.choice([-1, 1], 2)
        self._api.raw_motor(
            int(direction[0] * 100), int(direction[1] * 100), duration=1)
      time.sleep(4)
    else:
      self._camera.scramble()
    return self._obs(is_first=True)

  def _obs(self, is_first=False, is_last=False):
    frame = self._camera.color()
    pos, _, _ = self._tracker(frame)
    if pos is None:
      pos = np.array([0.5, 0.5])
    reward = -float(np.linalg.norm(pos - self._goal))
    import cv2
    image = cv2.resize(frame, (64, 64))[:, :, ::-1]  # BGR camera -> RGB.
    return dict(
        image=np.ascontiguousarray(image, np.uint8),
        goal=self._goal.copy(),
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=False,
        log_success=np.uint8(reward > -SUCCESS_THRESHOLD),
    )

  def close(self):
    if self._api is not None:
      self._api.__exit__(None, None, None)


class _RealSenseCamera:
  """Overhead RealSense color stream (reference sphero.py:66-76)."""

  def __init__(self):
    import pyrealsense2 as rs
    ctx = rs.context()
    for dev in ctx.query_devices():
      dev.hardware_reset()
    time.sleep(2)
    self.pipeline = rs.pipeline()
    config = rs.config()
    config.enable_stream(rs.stream.color, 640, 480, rs.format.bgr8, 30)
    self.pipeline.start(config)

  def color(self):
    frames = self.pipeline.wait_for_frames()
    return np.asanyarray(frames.get_color_frame().get_data())


class _SimCamera:
  """Kinematic ball + synthetic overhead frame for hardware-free runs.

  Raw motor commands (left, right) integrate into velocity like a
  differential drive on a damped surface; the rendered frame feeds the
  same BallTracker used on real footage.
  """

  def __init__(self, rng, arena_min=(193, 67), arena_max=(480, 370)):
    self._rng = rng
    self.arena_min = np.asarray(arena_min, np.float64)
    self.arena_max = np.asarray(arena_max, np.float64)
    self.pos = np.array([0.2, 0.8])  # Normalized arena coords.
    self.vel = np.zeros(2)

  def push(self, act):
    forward = (act[0] + act[1]) / 2.0
    turn = (act[0] - act[1]) / 2.0
    heading = np.arctan2(self.vel[1], self.vel[0]) if np.linalg.norm(
        self.vel) > 1e-3 else self._rng.uniform(0, 2 * np.pi)
    heading += 0.8 * turn
    self.vel = 0.6 * self.vel + 0.08 * forward * np.array(
        [np.cos(heading), np.sin(heading)])
    self.pos = np.clip(self.pos + self.vel, 0.02, 0.98)

  def scramble(self):
    self.pos = self._rng.uniform(0.1, 0.9, 2)
    self.vel = np.zeros(2)

  def color(self):
    # Real camera resolution so the tracker's blur/erode scales match.
    frame = np.zeros((480, 640, 3), np.uint8)
    frame[:] = (40, 35, 30)  # Dark arena floor (BGR).
    cx, cy = (self.arena_min + self.pos * (
        self.arena_max - self.arena_min)).astype(int)
    y, x = np.ogrid[:480, :640]
    ball = (x - cx) ** 2 + (y - cy) ** 2 <= 20 ** 2
    frame[ball] = (250, 250, 250)
    return frame
