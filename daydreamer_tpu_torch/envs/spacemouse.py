"""3Dconnexion SpaceMouse USB HID reader for teleoperated demo collection
(reference: embodied/envs/spacemouse.py). Import-gated on pyusb."""

import threading

import numpy as np


class SpaceMouse:

  VENDOR_ID = 0x256f
  PRODUCT_IDS = (0xc62e, 0xc62f, 0xc631, 0xc632, 0xc635)

  def __init__(self):
    import usb.core
    import usb.util
    self._usb = usb.core
    dev = None
    for product in self.PRODUCT_IDS:
      dev = usb.core.find(idVendor=self.VENDOR_ID, idProduct=product)
      if dev is not None:
        break
    if dev is None:
      raise RuntimeError('No SpaceMouse device found.')
    self._dev = dev
    if dev.is_kernel_driver_active(0):
      dev.detach_kernel_driver(0)
    self._endpoint = dev[0][(0, 0)][0]
    self._state = np.zeros(6, np.float32)  # x, y, z, roll, pitch, yaw.
    self._buttons = np.zeros(2, bool)
    self._lock = threading.Lock()
    self._running = True
    self._thread = threading.Thread(target=self._reader, daemon=True)
    self._thread.start()

  def read(self):
    with self._lock:
      return self._state.copy(), self._buttons.copy()

  def close(self):
    self._running = False

  def _reader(self):
    while self._running:
      try:
        data = self._dev.read(
            self._endpoint.bEndpointAddress,
            self._endpoint.wMaxPacketSize, timeout=100)
      except self._usb.USBError:
        continue
      with self._lock:
        if data[0] == 1:  # Translation.
          self._state[0:3] = self._decode(data[1:7]) / 350.0
        elif data[0] == 2:  # Rotation.
          self._state[3:6] = self._decode(data[1:7]) / 350.0
        elif data[0] == 3:  # Buttons.
          self._buttons[0] = bool(data[1] & 1)
          self._buttons[1] = bool(data[1] & 2)

  @staticmethod
  def _decode(data):
    values = np.frombuffer(bytes(data), np.int16)
    return values.astype(np.float32)
