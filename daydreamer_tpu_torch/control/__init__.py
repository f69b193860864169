"""Whole-body locomotion control: gait scheduling, Raibert swing legs,
stance-force QP (reference capability: the mpc_controller stack driven by
motion_imitation/examples/whole_body_controller_example.py)."""

from . import gait
from . import kinematics
from .gait import GaitScheduler, STANCE, SWING, EARLY_CONTACT, LOSE_CONTACT
from .locomotion import LocomotionController, VelocityEstimator, run_sim
from .stance import StanceForceController
from .swing import RaibertSwingController
