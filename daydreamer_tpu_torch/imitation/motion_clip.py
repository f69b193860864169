"""Motion clip loading, sampling, and procedural synthesis.

Replaces the reference's mocap pipeline (reference:
motion_imitation/utilities/motion_data.py:1-724, which loads JSON clips
of ``[root_pos(3), root_quat_xyzw(4), joints(12)]`` frames with wrap
looping and per-cycle root offsets). This build keeps the same on-disk
clip format (so reference clip files load unchanged) but stores frames
as one dense array and samples poses by vectorized interpolation. A
procedural gait synthesizer replaces shipped mocap data for the in-tree
examples/tests.
"""

import json

import numpy as np

POS, QUAT, JOINTS = slice(0, 3), slice(3, 7), slice(7, 19)
FRAME_DIM = 19


def _slerp(q0, q1, w):
  """Spherical interpolation between xyzw quaternions."""
  dot = float(np.dot(q0, q1))
  if dot < 0:
    q1, dot = -q1, -dot
  if dot > 0.9995:
    out = q0 + w * (q1 - q0)
    return out / np.linalg.norm(out)
  theta = np.arccos(np.clip(dot, -1, 1))
  s0 = np.sin((1 - w) * theta) / np.sin(theta)
  s1 = np.sin(w * theta) / np.sin(theta)
  return s0 * q0 + s1 * q1


class MotionClip:
  """A looping reference motion.

  Args:
    frames: [N, 19] array of [root_pos, root_quat_xyzw, 12 joint angles].
    frame_duration: seconds between frames.
    loop: 'Wrap' repeats the clip, accumulating the root displacement per
      cycle when cycle_offset_position is set (reference:
      motion_data.py LoopMode/EnableCycleOffsetPosition); 'Clamp' holds
      the final frame.
  """

  def __init__(self, frames, frame_duration, loop='Wrap',
               cycle_offset_position=True):
    self.frames = np.asarray(frames, np.float64)
    assert self.frames.ndim == 2 and self.frames.shape[1] == FRAME_DIM, (
        self.frames.shape)
    self.frame_duration = float(frame_duration)
    self.loop = loop
    self.cycle_offset_position = bool(cycle_offset_position)
    # Root displacement over one full cycle (applied per wrap).
    self._cycle_delta = self.frames[-1, POS] - self.frames[0, POS]

  @classmethod
  def from_file(cls, path):
    """Load a reference-format JSON clip file (motion_data.py format)."""
    with open(path) as f:
      data = json.load(f)
    return cls(
        np.asarray(data['Frames'], np.float64),
        data['FrameDuration'],
        loop=data.get('LoopMode', 'Wrap'),
        cycle_offset_position=data.get('EnableCycleOffsetPosition', True))

  @property
  def duration(self):
    return (len(self.frames) - 1) * self.frame_duration

  def phase(self, t):
    """Normalized [0, 1) phase within the current cycle."""
    if self.duration <= 0:
      return 0.0
    return (t / self.duration) % 1.0

  def pose_at(self, t):
    """Interpolated [19] pose at time t, honoring loop mode and offsets."""
    dur = self.duration
    if dur <= 0:
      return self.frames[0].copy()
    if self.loop == 'Clamp':
      cycles, t = 0, min(max(t, 0.0), dur)
    else:
      cycles, t = divmod(max(t, 0.0), dur)
    x = t / self.frame_duration
    i = min(int(x), len(self.frames) - 2)
    w = x - i
    f0, f1 = self.frames[i], self.frames[i + 1]
    pose = (1 - w) * f0 + w * f1
    pose[QUAT] = _slerp(f0[QUAT], f1[QUAT], w)
    if self.cycle_offset_position and cycles:
      pose[POS] = pose[POS] + cycles * self._cycle_delta
    return pose

  def joints_at(self, t):
    return self.pose_at(t)[JOINTS]

  def joint_velocity_at(self, t, eps=1e-3):
    """Finite-difference joint velocity at time t."""
    return (self.joints_at(t + eps) - self.joints_at(t - eps)) / (2 * eps)

  def save(self, path):
    with open(path, 'w') as f:
      json.dump({
          'LoopMode': self.loop,
          'FrameDuration': self.frame_duration,
          'EnableCycleOffsetPosition': self.cycle_offset_position,
          'EnableCycleOffsetRotation': False,
          'Frames': self.frames.tolist(),
      }, f)


# Leg phase offsets (fraction of a cycle) per gait, legs ordered
# [front_left, front_right, back_right, back_left].
GAIT_PHASES = {
    'trot': (0.0, 0.5, 0.0, 0.5),     # Diagonal pairs.
    'pace': (0.0, 0.5, 0.5, 0.0),     # Lateral pairs.
    'bound': (0.0, 0.0, 0.5, 0.5),    # Front/back pairs.
    'walk': (0.0, 0.5, 0.25, 0.75),   # Four-beat.
}


def synthesize_gait(gait='trot', standing_pose=None, swing_amp=0.35,
                    lift_amp=0.25, period=0.6, n_frames=40, speed=0.4,
                    height=0.55):
  """Procedurally generate a quadruped gait clip.

  Joint layout is (hip_swing, upper_pitch, knee) per leg in the order
  [FL, FR, BR, BL] — matching both the A1's 12-joint layout and the
  dm_control quadruped's actuated (yaw, pitch, knee) triplets, so the
  generated clip drives either robot without retargeting. The in-tree
  replacement for shipped mocap files (reference: data/motions/*.txt).
  """
  if gait not in GAIT_PHASES:
    raise ValueError(
        f'Unknown gait {gait!r}; available: {sorted(GAIT_PHASES)}')
  phases = GAIT_PHASES[gait]
  standing = (np.zeros(12) if standing_pose is None
              else np.asarray(standing_pose, np.float64))
  dt = period / n_frames
  frames = np.zeros((n_frames + 1, FRAME_DIM))
  for k in range(n_frames + 1):
    u = k / n_frames  # Cycle fraction.
    pose = frames[k]
    pose[POS] = (speed * period * u, 0.0, height)
    pose[QUAT] = (0.0, 0.0, 0.0, 1.0)  # xyzw identity.
    joints = standing.copy()
    for leg in range(4):
      ph = 2 * np.pi * (u + phases[leg])
      swing = np.sin(ph)
      # Lift only during the swing half of the cycle.
      lift = lift_amp * max(0.0, np.sin(ph + np.pi / 2))
      joints[3 * leg + 1] += swing_amp * swing - lift
      joints[3 * leg + 2] += 2 * lift
    pose[JOINTS] = joints
  return MotionClip(frames, dt, loop='Wrap', cycle_offset_position=True)
