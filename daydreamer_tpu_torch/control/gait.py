"""Open-loop phase gait scheduler with contact-aware leg states.

Covers the reference stack's gait generation capability (reference:
motion_imitation/examples/whole_body_controller_example.py:71-81 drives an
``openloop_gait_generator`` with per-leg stance duration, duty factor, and
initial phase; the trot preset there is duty 0.6 with diagonal pairs in
anti-phase).  Each leg advances a normalized cycle phase from wall time;
the duty factor splits the cycle into STANCE then SWING.  Measured foot
contact refines the nominal state near transitions: a swing leg that
touches down late in swing goes EARLY_CONTACT (treated as stance), a
stance leg without contact goes LOSE_CONTACT (treated as swing).
"""

import dataclasses

import numpy as np

STANCE = 0
SWING = 1
EARLY_CONTACT = 2
LOSE_CONTACT = 3


TROT = dict(
    stance_duration=(0.3, 0.3, 0.3, 0.3),
    duty_factor=(0.6, 0.6, 0.6, 0.6),
    initial_phase=(0.9, 0.0, 0.0, 0.9),
)

STAND = dict(
    stance_duration=(0.3, 0.3, 0.3, 0.3),
    duty_factor=(1.0, 1.0, 1.0, 1.0),
    initial_phase=(0.0, 0.0, 0.0, 0.0),
)


@dataclasses.dataclass
class LegTiming:
  state: int            # STANCE / SWING / EARLY_CONTACT / LOSE_CONTACT.
  nominal_state: int    # Phase-derived state ignoring contact.
  phase: float          # Normalized progress within the current sub-phase.


class GaitScheduler:

  def __init__(self, stance_duration=TROT['stance_duration'],
               duty_factor=TROT['duty_factor'],
               initial_phase=TROT['initial_phase'],
               early_contact_window=0.15):
    self._stance_duration = np.asarray(stance_duration, np.float64)
    self._duty = np.asarray(duty_factor, np.float64)
    self._offset = np.asarray(initial_phase, np.float64)
    self._cycle = self._stance_duration / np.maximum(self._duty, 1e-9)
    self._early_window = early_contact_window
    self.reset()

  def reset(self):
    self.legs = [LegTiming(STANCE, STANCE, 0.0) for _ in range(4)]

  @property
  def stance_duration(self):
    return self._stance_duration

  def update(self, time_now, contacts=(True,) * 4):
    """Advance leg phases to `time_now` seconds and fold in contact."""
    for leg in range(4):
      cycle_phase = (time_now / self._cycle[leg] + self._offset[leg]) % 1.0
      duty = self._duty[leg]
      if cycle_phase < duty:
        nominal, phase = STANCE, cycle_phase / max(duty, 1e-9)
      else:
        nominal, phase = SWING, (cycle_phase - duty) / max(1 - duty, 1e-9)
      state = nominal
      if nominal == SWING and contacts[leg]:
        if phase > 1.0 - self._early_window:
          state = EARLY_CONTACT
      elif nominal == STANCE and not contacts[leg]:
        state = LOSE_CONTACT
      timing = self.legs[leg]
      timing.state, timing.nominal_state, timing.phase = (
          state, nominal, phase)

  def stance_legs(self):
    """Legs that should bear load right now."""
    return [i for i, leg in enumerate(self.legs)
            if leg.state in (STANCE, EARLY_CONTACT)]

  def swing_legs(self):
    return [i for i, leg in enumerate(self.legs)
            if leg.state in (SWING, LOSE_CONTACT)]
