"""Gamepad teleoperation reader (Linux evdev, no vendored HID library).

Capability parity with the reference's gamepad stack, which vendors a
3.7k-line HID library (reference: third_party/inputs.py) consumed by a
Logitech F710 reader (reference:
motion_imitation/robots/gamepad/gamepad_reader.py:16-93). Controls match
the reference:

  1) LB+RB together at any time -> emergency stop (estop_flagged).
  2) Left stick -> forward/backward (vx) and lateral (vy) velocity.
  3) Right stick x -> yaw rate (wz).

Instead of a bundled HID stack, this reads the kernel's evdev character
devices (/dev/input/event*) directly: each read yields fixed-size
``input_event`` structs (struct timeval, u16 type, u16 code, s32 value),
so a ~100-line reader replaces the vendored library. A file-like object
can be injected for tests (see tests/test_envs.py).
"""

import os
import struct
import threading

# struct input_event on 64-bit Linux: timeval (2x long) + type + code + value.
_EVENT_FORMAT = 'llHHi'
_EVENT_SIZE = struct.calcsize(_EVENT_FORMAT)

# Linux input-event-codes.h constants.
EV_KEY = 0x01
EV_ABS = 0x03
BTN_TL = 0x136  # Left bumper.
BTN_TR = 0x137  # Right bumper.
ABS_X = 0x00    # Left stick horizontal.
ABS_Y = 0x01    # Left stick vertical.
ABS_RX = 0x03   # Right stick horizontal.
ABS_RY = 0x04   # Right stick vertical.

# Signed 16-bit stick range used by XInput-class pads (reference
# gamepad_reader.py MAX_ABS_RX/RY = 32768).
_MAX_ABS = 32768.0


def find_gamepad_device():
  """Return the /dev/input/event* path of the first joystick-class device.

  Scans /proc/bus/input/devices for a device whose handlers include a
  ``jsN`` node (the kernel marks joysticks this way) and returns its
  eventN path, or None if no gamepad is present.
  """
  try:
    with open('/proc/bus/input/devices') as f:
      blocks = f.read().split('\n\n')
  except OSError:
    return None
  for block in blocks:
    if 'js' not in block:
      continue
    for line in block.splitlines():
      if line.startswith('H:') and 'js' in line:
        for tok in line.split():
          if tok.startswith('event'):
            return '/dev/input/' + tok
  return None


class Gamepad:
  """Threaded gamepad command reader with the reference's surface.

  Attributes `vx`, `vy`, `wz` hold the current velocity command and
  `estop_flagged` latches once both bumpers are pressed (reference:
  gamepad_reader.py:24-93). `speed_command` returns (vx, vy, wz).

  Args:
    vel_scale_x/y/rot: maximum absolute commands mapped to full stick.
    device: path to an event device, or an open binary file-like object
      (tests inject synthetic event streams this way). Defaults to
      auto-discovery via /proc/bus/input/devices.
  """

  def __init__(self, vel_scale_x=0.4, vel_scale_y=0.4, vel_scale_rot=1.0,
               device=None):
    self._scales = (vel_scale_x, vel_scale_y, vel_scale_rot)
    self._lb_pressed = False
    self._rb_pressed = False
    self.vx, self.vy, self.wz = 0.0, 0.0, 0.0
    self.estop_flagged = False
    self.is_running = True
    if device is None:
      device = find_gamepad_device()
      if device is None:
        raise RuntimeError('No gamepad found (no js handler in '
                           '/proc/bus/input/devices).')
    if isinstance(device, (str, os.PathLike)):
      self._file = open(device, 'rb', buffering=0)
    else:
      self._file = device
    self._thread = threading.Thread(target=self._read_loop, daemon=True)
    self._thread.start()

  def speed_command(self):
    return (self.vx, self.vy, self.wz)

  def stop(self):
    self.is_running = False
    try:
      self._file.close()
    except OSError:
      pass
    self._thread.join(timeout=1.0)

  def _read_loop(self):
    while self.is_running and not self.estop_flagged:
      try:
        buf = self._file.read(_EVENT_SIZE)
      except (OSError, ValueError):
        break
      if not buf or len(buf) < _EVENT_SIZE:
        break
      _, _, etype, code, value = struct.unpack(_EVENT_FORMAT, buf)
      self._update(etype, code, value)

  def _update(self, etype, code, value):
    sx, sy, srot = self._scales
    if etype == EV_KEY and code == BTN_TL:
      self._lb_pressed = bool(value)
    elif etype == EV_KEY and code == BTN_TR:
      self._rb_pressed = bool(value)
    elif etype == EV_ABS and code == ABS_Y:
      # Stick up (negative raw) -> positive forward velocity.
      self.vx = -value / _MAX_ABS * sx
    elif etype == EV_ABS and code == ABS_X:
      self.vy = -value / _MAX_ABS * sy
    elif etype == EV_ABS and code == ABS_RX:
      self.wz = -value / _MAX_ABS * srot
    if self._lb_pressed and self._rb_pressed:
      # Latched estop zeroes the command, matching the reference's
      # behavior of freezing the robot (gamepad_reader.py:66-73).
      self.estop_flagged = True
      self.vx, self.vy, self.wz = 0.0, 0.0, 0.0


def pack_event(etype, code, value):
  """Pack one input_event struct (test helper / synthetic streams)."""
  return struct.pack(_EVENT_FORMAT, 0, 0, etype, code, value)
