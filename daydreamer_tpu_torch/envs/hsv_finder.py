"""Interactive HSV threshold calibration for camera-based object tracking
(reference: embodied/envs/hsv_finder.py), used to tune the Sphero overhead
tracker. Sliders adjust the HSV bounds; the masked view updates live.

Usage: python -m daydreamer_tpu_torch.envs.hsv_finder [--camera 0]
"""

import numpy as np


def main(argv=None):
  import cv2
  from .. import core
  parsed = core.Flags(camera=0, image='').parse(argv)

  window = 'hsv_finder'
  cv2.namedWindow(window)
  for name, maximum, default in [
      ('H low', 179, 0), ('S low', 255, 0), ('V low', 255, 0),
      ('H high', 179, 179), ('S high', 255, 255), ('V high', 255, 255)]:
    cv2.createTrackbar(name, window, default, maximum, lambda x: None)

  if parsed.image:
    frame = cv2.imread(parsed.image)
    grab = lambda: (True, frame.copy())
  else:
    cap = cv2.VideoCapture(parsed.camera)
    grab = cap.read

  while True:
    ok, frame = grab()
    if not ok:
      break
    hsv = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV)
    low = np.array([cv2.getTrackbarPos(f'{c} low', window)
                    for c in 'HSV'])
    high = np.array([cv2.getTrackbarPos(f'{c} high', window)
                     for c in 'HSV'])
    mask = cv2.inRange(hsv, low, high)
    masked = cv2.bitwise_and(frame, frame, mask=mask)
    cv2.imshow(window, np.concatenate([frame, masked], 1))
    if cv2.waitKey(30) & 0xFF in (27, ord('q')):
      print(f'low={low.tolist()} high={high.tolist()}')
      break
  cv2.destroyAllWindows()


if __name__ == '__main__':
  main()
