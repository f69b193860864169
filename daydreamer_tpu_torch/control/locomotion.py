"""Whole-body locomotion controller: gait + swing IK + stance-force QP.

Covers the reference's ``locomotion_controller`` composition (reference:
motion_imitation/examples/whole_body_controller_example.py:102-141: an
openloop gait generator, a COM velocity estimator, a Raibert swing-leg
controller, and a QP stance-torque controller driven by velocity
commands).  Each control tick reads the robot state, advances the gait,
and produces one 12-vector of motor torques: swing legs run joint PD
toward their IK targets, stance legs apply tau = J^T f from the
friction-pyramid force QP.
"""

import numpy as np

from ..envs import a1_model
from . import gait as gaitlib
from . import kinematics
from .stance import StanceForceController
from .swing import RaibertSwingController

SWING_KP = np.array([100.0, 100.0, 100.0] * 4).reshape(4, 3)
SWING_KD = np.array([1.0, 2.0, 2.0] * 4).reshape(4, 3)


class VelocityEstimator:
  """Moving-average COM velocity in the yaw-aligned (heading) frame
  (reference role: mpc_controller/com_velocity_estimator, window 20)."""

  def __init__(self, window=20):
    self._window = window
    self._history = []

  def reset(self):
    self._history.clear()

  def update(self, world_velocity, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    heading = np.array([
        c * world_velocity[0] + s * world_velocity[1],
        -s * world_velocity[0] + c * world_velocity[1],
        world_velocity[2]])
    self._history.append(heading)
    if len(self._history) > self._window:
      self._history.pop(0)

  @property
  def velocity(self):
    if not self._history:
      return np.zeros(3)
    return np.mean(self._history, 0)


class LocomotionController:
  """Produces motor torques for the MuJoCo A1 from velocity commands."""

  def __init__(self, gait=None, desired_height=0.26):
    self.gait = gait or gaitlib.GaitScheduler()
    self.estimator = VelocityEstimator()
    self.swing = RaibertSwingController(
        self.gait, desired_height=desired_height)
    self.stance = StanceForceController(
        self.gait, desired_height=desired_height)
    self._height = desired_height
    self._swing_targets = {}

  def reset(self):
    self.gait.reset()
    self.estimator.reset()
    self.swing.reset()
    self._swing_targets = {}

  def torques(self, robot, desired_velocity=(0.0, 0.0),
              desired_yaw_rate=0.0):
    """One control tick: full 12-vector of joint torques."""
    roll, pitch, yaw = robot.base_rpy
    self.estimator.update(robot.base_velocity, yaw)
    velocity = self.estimator.velocity
    omega_world = robot.base_angular_velocity
    # Yaw-frame angular velocity (roll/pitch rates approximately equal
    # body rates at small attitude).
    c, s = np.cos(yaw), np.sin(yaw)
    omega = np.array([
        c * omega_world[0] + s * omega_world[1],
        -s * omega_world[0] + c * omega_world[1],
        omega_world[2]])
    contacts = robot.foot_contacts()
    self.gait.update(robot.time_s, contacts)

    motor_angles = robot.motor_angles
    motor_velocities = robot.motor_velocities
    desired_velocity = np.asarray(desired_velocity, np.float64)

    # Swing: IK joint targets tracked by joint PD.
    self._swing_targets = self.swing.joint_targets(
        motor_angles, velocity, desired_velocity,
        omega[2], desired_yaw_rate)

    # Stance: wrench PD -> force QP -> Jacobian-transpose torques.
    stance_legs = self.gait.stance_legs()
    height = float(robot.data.qpos[2])
    wrench = self.stance.desired_wrench(
        height, roll, pitch, velocity, omega,
        desired_velocity, desired_yaw_rate)
    foot_positions = kinematics.all_foot_positions(motor_angles)
    forces = self.stance.contact_forces(wrench, foot_positions, stance_legs)
    stance_torques = self.stance.leg_torques(motor_angles, forces)

    q = motor_angles.reshape(4, 3)
    dq = motor_velocities.reshape(4, 3)
    torques = np.zeros((4, 3))
    for leg in range(4):
      if leg in stance_torques:
        torques[leg] = stance_torques[leg]
      elif leg in self._swing_targets:
        torques[leg] = (SWING_KP[leg] * (self._swing_targets[leg] - q[leg])
                        - SWING_KD[leg] * dq[leg])
      else:  # No allocation (transient): hold position.
        torques[leg] = -SWING_KD[leg] * dq[leg]
    return torques.reshape(-1)


def run_sim(seconds=4.0, command=(0.4, 0.0), yaw_rate=0.0, seed=0,
            control_hz=500, robot=None, controller=None):
  """Drive the MuJoCo A1 with the whole-body controller; returns summary
  stats (used by the example and tests)."""
  if robot is None:
    robot = a1_model.A1Robot(action_repeat=1, seed=seed)
    robot.reset()
  if controller is None:
    controller = LocomotionController()
    controller.reset()
  substeps_per_tick = max(1, int(round(
      1.0 / (control_hz * a1_model.SIM_TIMESTEP))))
  start_xy = robot.data.qpos[:2].copy()
  start_yaw = robot.base_rpy[2]
  min_up = 1.0
  heights = []
  steps = int(seconds / a1_model.SIM_TIMESTEP / substeps_per_tick)
  for _ in range(steps):
    tau = controller.torques(robot, command, yaw_rate)
    for _ in range(substeps_per_tick):
      robot.substep_torque(tau)
    min_up = min(min_up, robot.rot_mat[2, 2])
    heights.append(float(robot.data.qpos[2]))
  end_xy = robot.data.qpos[:2].copy()
  return dict(
      displacement=np.asarray(end_xy - start_xy),
      yaw_change=float(robot.base_rpy[2] - start_yaw),
      min_uprightness=float(min_up),
      mean_height=float(np.mean(heights)),
      robot=robot,
  )
