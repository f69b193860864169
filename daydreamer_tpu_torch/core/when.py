"""Schedule predicates used by the run loops.

Capability parity with the reference schedules (embodied/core/when.py):
``Every`` fires on a step period, ``Once`` fires a single time, ``Until``
holds while below a step limit, and ``Clock`` fires on a wall-time period.
A falsy period disables ``Every``/``Clock`` entirely and makes ``Until``
always true.
"""

import time


class Every:
  """True once per `period` steps, starting with the first call."""

  def __init__(self, period):
    self.period = period
    self.due_at = None

  def __call__(self, step):
    if not self.period:
      return False
    step = int(step)
    if self.due_at is None:
      self.due_at = step + self.period
      return True
    if step < self.due_at:
      return False
    self.due_at += self.period
    return True


class Once:
  """True on the first call only."""

  def __init__(self):
    self.fired = False

  def __call__(self):
    fired, self.fired = self.fired, True
    return not fired


class Until:
  """True while the step count is below the limit (or no limit is set)."""

  def __init__(self, limit):
    self.limit = limit

  def __call__(self, step):
    if not self.limit:
      return True
    return int(step) < self.limit


class Clock:
  """True once per `period` wall-clock seconds, starting immediately.

  Fires on a fixed cadence (the deadline advances by whole periods), but
  resynchronizes to the current time when more than one period behind, so a
  long stall does not cause a burst of catch-up fires.
  """

  def __init__(self, period):
    self.period = period
    self.due_at = None

  def __call__(self, step=None):
    if not self.period:
      return False
    now = time.time()
    if self.due_at is None:
      self.due_at = now + self.period
      return True
    if now < self.due_at:
      return False
    self.due_at += self.period
    if self.due_at < now:
      self.due_at = now + self.period
    return True
