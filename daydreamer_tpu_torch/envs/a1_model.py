"""Unitree A1 quadruped simulation on MuJoCo.

Replaces the reference's PyBullet A1 stack (reference:
motion_imitation/robots/a1.py:266-729, robots/minitaur.py:85-1529,
envs/locomotion_gym_env.py:35-526) with a MuJoCo-native robot built from
the same vendor kinematics, masses, and joint limits (the constants below
are the Unitree A1 hardware spec, cf. the vendor URDF). Behavior kept:

- 12 position-commanded motors driven by an explicit PD motor model at
  the 1 kHz physics rate (kp 100, kd 1/2/2, torque clip 42 Nm; reference:
  robots/a1.py:80-86, laikago_motor.py:39-140).
- Policy actions in [-1, 1]^12 mapped to joint targets through the
  asymmetric usable-range map `unnormalize_action` (reference:
  robots/a1.py:130-156 MOTOR_USED fractions over MOTOR_MINS/MAXS).
- Butterworth action filtering at the control rate, linear interpolation
  of targets across the action repeat, and per-substep command clipping
  to joint limits and a max angle change (reference: minitaur.py:258-270,
  1474-1510; a1.py:563-580).
- `_SafeJointsReset`: on reset, clip joints into bounds and PD them to
  safety before handing control to the policy (reference:
  minitaur.py:421-448).

Observations are the reference's sensor suite: 12 motor angles plus IMU
[roll, pitch, roll_rate, pitch_rate] (reference: env_builder.py:62-73).
"""

import collections
import math

import numpy as np

# --- Unitree A1 hardware constants (vendor spec). ---

NUM_MOTORS = 12
# Per-joint-type position limits, repeated over the four legs in
# (abduction/hip, thigh/upper, calf/knee) order.
MOTOR_MINS = np.array([-0.802851455917, -1.0471975512, -2.69653369433] * 4)
MOTOR_MAXS = np.array([0.802851455917, 4.18879020479, -0.916297857297] * 4)
# Usable fraction of each range; keeps targets away from hard stops and
# makes the action mapping asymmetric (reference: robots/a1.py:123-128).
MOTOR_USED = np.array([[0.01, 0.99], [0.01, 0.90], [0.01, 0.60]] * 4)
MOTOR_OFFSETS = np.zeros(NUM_MOTORS)
# Normalized-units pose the RMA reward pulls toward (reference a1.py:130).
STANDING_POSE = np.array([0.0, -0.2, 1.0] * 4)
# Joint-space crouch pose used for resets (reference a1.py:88).
INIT_MOTOR_ANGLES = np.array([0.0, 0.9, -1.8] * 4)

PD_KP = np.array([100.0, 100.0, 100.0] * 4)
PD_KD = np.array([1.0, 2.0, 2.0] * 4)
MAX_TORQUE = 42.0
MAX_ANGLE_CHANGE_PER_SUBSTEP = 0.2  # reference a1.py:63

# Leg layout: (name, x sign of hip on trunk, y sign of hip on trunk).
LEGS = (('FR', 1, -1), ('FL', 1, 1), ('RR', -1, -1), ('RL', -1, 1))
HIP_X, HIP_Y = 0.183, 0.047
THIGH_OFFSET = 0.08505     # Lateral hip->thigh distance.
THIGH_LEN = CALF_LEN = 0.2

SIM_TIMESTEP = 0.001


def unnormalize_action(action, clip=True):
  """[-1, 1]^12 policy action -> joint-angle targets (rad).

  The usable window per joint is [lo, hi] where lo/hi interpolate between
  the hard limits by the MOTOR_USED fractions (reference a1.py:133-142).
  """
  if clip:
    action = np.clip(action, -1, 1)
  frac = action / 2 + 0.5
  lo = MOTOR_MINS + MOTOR_USED[:, 0] * (MOTOR_MAXS - MOTOR_MINS)
  hi = MOTOR_MINS + MOTOR_USED[:, 1] * (MOTOR_MAXS - MOTOR_MINS)
  return frac * (hi - lo) + lo + MOTOR_OFFSETS


def normalize_action(angles, clip=True):
  """Joint angles (rad) -> normalized [-1, 1]^12 (reference a1.py:144-153)."""
  angles = np.asarray(angles) - MOTOR_OFFSETS
  lo = MOTOR_MINS + MOTOR_USED[:, 0] * (MOTOR_MAXS - MOTOR_MINS)
  hi = MOTOR_MINS + MOTOR_USED[:, 1] * (MOTOR_MAXS - MOTOR_MINS)
  out = ((angles - lo) / (hi - lo) - 0.5) * 2
  if clip:
    out = np.clip(out, -1, 1)
  return out


def _leg_xml(name, sx, sy):
  """MJCF for one leg; masses/inertias/limits from the vendor spec."""
  mirror = -sy  # Hip/thigh inertia products mirror left<->right.
  return f"""
    <body name="{name}_hip" pos="{sx * HIP_X} {sy * HIP_Y} 0">
      <joint name="{name}_hip_joint" axis="1 0 0"
             range="{MOTOR_MINS[0]} {MOTOR_MAXS[0]}" damping="0.01"/>
      <inertial pos="-0.003311 {sy * 0.000635} 0.000031" mass="0.696"
                fullinertia="0.000469246 0.00080749 0.000552929
                             {mirror * -9.409e-06} -3.42e-07
                             {mirror * 4.66e-07}"/>
      <geom type="cylinder" size="0.041 0.016" euler="1.5707963 0 0"
            mass="0" contype="0" conaffinity="0" rgba="0.2 0.2 0.2 1"/>
      <body name="{name}_thigh" pos="0 {sy * THIGH_OFFSET} 0">
        <joint name="{name}_thigh_joint" axis="0 1 0"
               range="{MOTOR_MINS[1]} {MOTOR_MAXS[1]}" damping="0.01"/>
        <inertial pos="-0.003237 {-sy * 0.022327} -0.027326" mass="1.013"
                  fullinertia="0.005529065 0.005139339 0.001367788
                               {mirror * 4.825e-06} 0.000343869
                               {mirror * -2.2448e-05}"/>
        <geom type="box" size="{THIGH_LEN / 2} 0.01225 0.017"
              pos="0 0 {-THIGH_LEN / 2}" euler="0 1.5707963 0" mass="0"
              contype="1" conaffinity="0" rgba="0.3 0.3 0.35 1"/>
        <body name="{name}_calf" pos="0 0 {-THIGH_LEN}">
          <joint name="{name}_calf_joint" axis="0 1 0"
                 range="{MOTOR_MINS[2]} {MOTOR_MAXS[2]}" damping="0.01"/>
          <geom type="box" size="{CALF_LEN / 2} 0.008 0.008"
                pos="0 0 {-CALF_LEN / 2}" euler="0 1.5707963 0" mass="0.166"
                contype="1" conaffinity="0" rgba="0.15 0.15 0.15 1"/>
          <geom name="{name}_foot" type="sphere" size="0.02"
                pos="0 0 {-CALF_LEN}" mass="0.06" contype="1" conaffinity="0"
                friction="1.0 0.005 0.0001" rgba="0.1 0.1 0.1 1"/>
        </body>
      </body>
    </body>"""


def build_mjcf():
  legs = ''.join(_leg_xml(*leg) for leg in LEGS)
  return f"""
<mujoco model="unitree_a1">
  <compiler angle="radian"/>
  <option timestep="{SIM_TIMESTEP}" gravity="0 0 -9.81"/>
  <asset>
    <texture name="grid" type="2d" builtin="checker" width="256" height="256"
             rgb1="0.22 0.25 0.28" rgb2="0.28 0.31 0.34"/>
    <material name="grid" texture="grid" texrepeat="8 8" reflectance="0.1"/>
  </asset>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1" directional="true"/>
    <geom name="floor" type="plane" size="50 50 1" material="grid"
          friction="1.0 0.005 0.0001" contype="1" conaffinity="1"/>
    <body name="trunk" pos="0 0 0.32">
      <freejoint name="root"/>
      <camera name="track" mode="trackcom" pos="0 -0.9 0.35"
              xyaxes="1 0 0 0 0.37 0.93"/>
      <inertial pos="0.012731 0.002186 0.000515" mass="4.713"
                fullinertia="0.01683993 0.056579028 0.064713601
                             8.3902e-05 0.000597679 2.5134e-05"/>
      <geom type="box" size="0.1335 0.097 0.057" mass="0"
            contype="1" conaffinity="0" rgba="0.45 0.5 0.55 1"/>
      <site name="imu" pos="0 0 0" size="0.01"/>
      {legs}
    </body>
  </worldbody>
  <sensor>
    <gyro name="gyro" site="imu"/>
  </sensor>
</mujoco>"""


def quat_to_roll_pitch(q):
  """wxyz quaternion -> (roll, pitch) in the XYZ euler convention the
  reference reads from pybullet.getEulerFromQuaternion."""
  w, x, y, z = q
  roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
  pitch = math.asin(max(-1.0, min(1.0, 2 * (w * y - z * x))))
  return roll, pitch


class A1Robot:
  """MuJoCo A1 with the reference motor pipeline and sensor suite."""

  def __init__(self, action_repeat=20, render_size=(64, 64), seed=None,
               enable_action_filter=True, enable_action_interpolation=True,
               enable_clip_motor_commands=True, sensor_latency=0.0):
    import os
    os.environ.setdefault('MUJOCO_GL', 'egl')  # Headless rendering.
    import mujoco
    self._mujoco = mujoco
    self.model = mujoco.MjModel.from_xml_string(build_mjcf())
    self.data = mujoco.MjData(self.model)
    self.action_repeat = int(action_repeat)
    self.render_size = tuple(render_size)
    self._rng = np.random.default_rng(seed)
    self._filter = None
    if enable_action_filter:
      from .drivers.action_filter import ActionFilterButter
      rate = 1.0 / (SIM_TIMESTEP * self.action_repeat)
      self._filter = ActionFilterButter(
          sampling_rate=rate, dims=NUM_MOTORS)
    self._interpolate = enable_action_interpolation
    self._clip_commands = enable_clip_motor_commands
    self._last_target = None
    self._step_counter = 0
    self._renderer = None
    # Sensor latency emulation (reference minitaur.py delayed-observation
    # buffer): proprio observations read the state `sensor_latency` seconds
    # in the past, snapshotted once per physics substep.
    assert sensor_latency >= 0, sensor_latency
    self._latency_substeps = int(round(sensor_latency / SIM_TIMESTEP))
    self._obs_history = collections.deque(
        maxlen=self._latency_substeps + 1)

  # -- State readers (reference Minitaur observation getters). --

  @property
  def motor_angles(self):
    return self.data.qpos[7:].copy()

  @property
  def motor_velocities(self):
    return self.data.qvel[6:].copy()

  @property
  def base_velocity(self):
    """World-frame linear velocity (reference GetBaseVelocity)."""
    return self.data.qvel[:3].copy()

  @property
  def base_quaternion(self):
    return self.data.qpos[3:7].copy()  # wxyz

  @property
  def rot_mat(self):
    """Row-major 3x3 trunk rotation (reference getMatrixFromQuaternion)."""
    return self.data.xmat[self.model.body('trunk').id].reshape(3, 3)

  def imu(self):
    """[roll, pitch, roll_rate, pitch_rate] like the reference IMUSensor."""
    roll, pitch = quat_to_roll_pitch(self.base_quaternion)
    gyro = self.data.sensordata[:3]  # Body-frame angular velocity.
    return np.array([roll, pitch, gyro[0], gyro[1]], np.float32)

  @property
  def base_rpy(self):
    """(roll, pitch, yaw) of the trunk."""
    w, x, y, z = self.base_quaternion
    roll, pitch = quat_to_roll_pitch(self.base_quaternion)
    yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.array([roll, pitch, yaw])

  @property
  def base_angular_velocity(self):
    """World-frame trunk angular velocity."""
    # MuJoCo free-joint qvel stores angular velocity in the body frame.
    return self.rot_mat @ self.data.qvel[3:6]

  @property
  def time_s(self):
    return float(self.data.time)

  def foot_contacts(self):
    """Which feet currently touch the floor (FR, FL, RR, RL)."""
    floor = self.model.geom('floor').id
    feet = [self.model.geom(f'{name}_foot').id for name, _, _ in LEGS]
    touching = [False] * 4
    for contact in self.data.contact[:self.data.ncon]:
      pair = {contact.geom1, contact.geom2}
      if floor in pair:
        for i, foot in enumerate(feet):
          if foot in pair:
            touching[i] = True
    return touching

  def substep_torque(self, torque):
    """Advance one physics substep applying raw joint torques (used by the
    whole-body controller; bypasses the PD position pipeline)."""
    torque = np.clip(torque, -MAX_TORQUE, MAX_TORQUE)
    self.data.qfrc_applied[6:] = torque
    self._mujoco.mj_step(self.model, self.data)
    if self._latency_substeps:
      self._obs_history.append(self._raw_observation())

  def _raw_observation(self):
    return np.concatenate([
        self.motor_angles.astype(np.float32), self.imu()])

  def observation(self):
    """Reference sensor suite: motor angles ++ IMU (env_builder.py:62-73),
    delayed by the emulated sensor latency when one is configured."""
    if not self._latency_substeps:
      return self._raw_observation()
    if not self._obs_history:
      self._obs_history.append(self._raw_observation())
    return self._obs_history[0]

  # -- Motor pipeline. --

  def _pd_substep(self, target):
    if self._clip_commands:
      q = self.motor_angles
      lb = np.maximum(MOTOR_MINS, q - MAX_ANGLE_CHANGE_PER_SUBSTEP)
      ub = np.minimum(MOTOR_MAXS, q + MAX_ANGLE_CHANGE_PER_SUBSTEP)
      target = np.clip(target, lb, ub)
    torque = (PD_KP * (target - self.motor_angles)
              - PD_KD * self.motor_velocities)
    torque = np.clip(torque, -MAX_TORQUE, MAX_TORQUE)
    self.data.qfrc_applied[6:] = torque
    self._mujoco.mj_step(self.model, self.data)
    if self._latency_substeps:
      self._obs_history.append(self._raw_observation())

  def apply_action(self, action):
    """One env step: action in [-1,1]^12 -> `action_repeat` PD substeps."""
    target = unnormalize_action(np.asarray(action, np.float64))
    if self._filter is not None:
      if self._step_counter == 0:
        self._filter.init_history(self.motor_angles)
      target = self._filter.filter(target)
    prev = self._last_target
    for i in range(self.action_repeat):
      if self._interpolate and prev is not None:
        lerp = (i + 1) / self.action_repeat
        sub = prev + lerp * (target - prev)
      else:
        sub = target
      self._pd_substep(sub)
    self._last_target = target
    self._step_counter += 1

  # -- Reset (reference minitaur.py:400-448). --

  def reset(self, at_current_position=False, settle_time=0.5):
    if not at_current_position:
      self.data.qpos[:] = 0
      self.data.qvel[:] = 0
      self.data.qpos[2] = 0.32
      self.data.qpos[3] = 1.0  # Identity quaternion.
      self.data.qpos[7:] = INIT_MOTOR_ANGLES
      self._mujoco.mj_forward(self.model, self.data)
      # Settle: hold the crouch pose while the robot lands on its feet.
      for _ in range(int(settle_time / SIM_TIMESTEP)):
        self._pd_substep(INIT_MOTOR_ANGLES)
    self._safe_joints_reset()
    if self._filter is not None:
      self._filter.reset()
    self._last_target = None
    self._step_counter = 0
    self._obs_history.clear()

  def _safe_joints_reset(self, max_substeps=100):
    """Move joints within bounds before the episode (minitaur.py:421-448)."""
    target = np.clip(self.motor_angles, MOTOR_MINS + 0.1, MOTOR_MAXS - 0.1)
    for _ in range(max_substeps):
      q = self.motor_angles
      if ((q <= MOTOR_MAXS - 0.03) & (q >= MOTOR_MINS + 0.03)).all():
        break
      self._pd_substep(target)

  # -- Rendering. --

  def render(self, size=None):
    size = tuple(size or self.render_size)
    if self._renderer is None or self._renderer_size != size:
      self._renderer = self._mujoco.Renderer(self.model, size[0], size[1])
      self._renderer_size = size
    self._renderer.update_scene(self.data, camera='track')
    return self._renderer.render()

  def close(self):
    if self._renderer is not None:
      self._renderer.close()
      self._renderer = None


class RMATask:
  """The reference's stand+walk shaped reward, unscaled (reference:
  motion_imitation/envs/env_wrappers/rma_task.py:6-56).

  r_upr + gated hip/shoulder/knee posture terms + 10 * (r_vel + 1) / 2,
  where each posture gate only opens once the previous term exceeds 0.7
  and r_vel rewards world-frame velocity along the trunk's heading.
  """

  def __init__(self, des_forward_speed=0.3):
    self.des_forward_speed = des_forward_speed

  def __call__(self, robot):
    rot = robot.rot_mat
    heading = np.array([rot[0, 0], rot[1, 0], 0.0])
    up_z = rot[2, 2]
    normed = normalize_action(robot.motor_angles)
    dev = np.abs(normed - STANDING_POSE)
    worst = np.maximum(1 - STANDING_POSE, 1 + STANDING_POSE)
    dev = np.clip(dev / worst, 0, 1)
    r_upr = up_z / 2 + 0.5
    r_hip = (r_upr > 0.7) * (1 - dev[0::3].mean())
    r_sho = (r_hip > 0.7) * (1 - dev[1::3].mean())
    r_kne = (r_sho > 0.7) * (1 - dev[2::3].mean())
    vel = robot.base_velocity
    forward_vel = float(np.dot(vel, heading))
    total_vel = float(np.linalg.norm(vel))
    forward_frac = max(0.0, forward_vel) / max(total_vel, 1e-8)
    forward_going = float(np.clip(forward_vel / self.des_forward_speed, -1, 1))
    r_vel = (r_kne > 0.7) * forward_frac * forward_going
    return float(r_upr + r_hip + r_sho + r_kne + 10 * (r_vel + 1) / 2)
