"""Step-indexed metric logger with pluggable output sinks.

Parity with the reference logger (reference: embodied/core/logger.py:11-258):
value rank decides scalar/image/video routing, a multiplier accounts for
env-repeat/fleet scaling, fps is computed between writes, and writes fan out
to sinks. Sinks: Terminal, JSONL, TensorBoard (with GIF videos when
tensorboard+ffmpeg are available), and an async wrapper that offloads
writes to a single worker thread.
"""

import concurrent.futures
import datetime
import json
import re
import time

import numpy as np

from . import path as pathlib


class Logger:

  def __init__(self, step, outputs, multiplier=1):
    self.step = step
    self._outputs = outputs
    self._multiplier = multiplier
    self._fps_anchor = None  # (wall time, scaled step) of the last write.
    self._metrics = []

  def add(self, mapping, prefix=None):
    step = int(self.step) * self._multiplier
    for name, value in dict(mapping).items():
      name = f'{prefix}/{name}' if prefix else name
      value = np.asarray(value)
      if len(value.shape) not in (0, 2, 3, 4):
        raise ValueError(
            f"Shape {value.shape} for name '{name}' cannot be "
            "interpreted as scalar, image, or video.")
      self._metrics.append((step, name, value))

  def scalar(self, name, value):
    self.add({name: value})

  def image(self, name, value):
    self.add({name: value})

  def video(self, name, value):
    self.add({name: value})

  def write(self, fps=False):
    fps and self.scalar('fps', self._compute_fps())
    if not self._metrics:
      return
    for output in self._outputs:
      output(tuple(self._metrics))
    self._metrics.clear()

  def _compute_fps(self):
    # Steps per second since the previous write, from a single anchor
    # tuple that rolls forward on every call.
    now = time.time()
    step = int(self.step) * self._multiplier
    anchor, self._fps_anchor = self._fps_anchor, (now, step)
    if anchor is None:
      return 0.0
    elapsed = now - anchor[0]
    return (step - anchor[1]) / elapsed if elapsed > 0 else 0.0


class AsyncOutput:

  def __init__(self, callback, parallel=True):
    self._callback = callback
    self._parallel = parallel
    if parallel:
      self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
      self._future = None

  def __call__(self, summaries):
    if self._parallel:
      self._future and self._future.result()
      self._future = self._executor.submit(self._callback, summaries)
    else:
      self._callback(summaries)


class TerminalOutput:

  def __init__(self, pattern=r'.*', name=None):
    self._pattern = re.compile(pattern)
    self._name = name

  def __call__(self, summaries):
    step = max(s for s, _, _, in summaries)
    scalars = {
        k: float(v) for _, k, v in summaries
        if len(v.shape) == 0 and self._pattern.search(k)}
    formatted = {k: self._format_value(v) for k, v in scalars.items()}
    header = f'{"-"*26}[{self._name + " " if self._name else ""}'
    header += f'Step {step:_}]{"-"*26}'
    print(header)
    print(' / '.join(f'{k} {v}' for k, v in formatted.items()))

  def _format_value(self, value):
    # Compact display: trimmed two-decimal fixed point in the readable
    # range, mantissa'e'exponent scientific notation outside it.
    if value == 0:
      return '0'
    if 0.01 < abs(value) < 10000:
      text = f'{value:.2f}'
      while text[-1] == '0':
        text = text[:-1]
      return text[:-1] if text[-1] == '.' else text
    mantissa, _, exponent = f'{value:.1e}'.partition('e')
    if not exponent:
      return mantissa  # nan/inf have no exponent part.
    if mantissa.endswith('.0'):
      mantissa = mantissa[:-2]
    return f'{mantissa}e{int(exponent)}'


class JSONLOutput(AsyncOutput):

  def __init__(self, logdir, filename='metrics.jsonl', pattern=r'.*',
               parallel=True):
    super().__init__(self._write, parallel)
    self._pattern = re.compile(pattern)
    self._logdir = pathlib.Path(logdir)
    self._logdir.mkdirs()
    self._filename = filename

  def _write(self, summaries):
    bystep = {}
    for step, name, value in summaries:
      if len(value.shape) == 0 and self._pattern.search(name):
        bystep.setdefault(step, {})[name] = float(value)
    lines = ''.join(
        json.dumps({'step': step, **scalars}) + '\n'
        for step, scalars in bystep.items())
    if lines:
      (self._logdir / self._filename).write(lines, mode='a')


class TensorBoardOutput(AsyncOutput):

  def __init__(self, logdir, fps=20, parallel=True):
    super().__init__(self._write, parallel)
    self._logdir = str(logdir)
    self._fps = fps
    self._writer = None

  def _write(self, summaries):
    try:
      from torch.utils.tensorboard import SummaryWriter
    except ImportError:
      return
    if not self._writer:
      self._writer = SummaryWriter(self._logdir)
    for step, name, value in summaries:
      if len(value.shape) == 0:
        self._writer.add_scalar('scalars/' + name, float(value), step)
      elif len(value.shape) == 2:
        self._writer.add_image(name, value, step, dataformats='HW')
      elif len(value.shape) == 3:
        self._writer.add_image(name, value, step, dataformats='HWC')
      elif len(value.shape) == 4:
        # T,H,W,C video. torch's add_video requires moviepy; fall back to
        # a PIL-encoded GIF on disk plus a middle frame in TensorBoard.
        video = value
        if np.issubdtype(video.dtype, np.floating):
          video = np.clip(255 * video, 0, 255).astype(np.uint8)
        try:
          self._writer.add_video(
              name, video.transpose((0, 3, 1, 2))[None], step,
              fps=self._fps)
        except ImportError:
          self._write_gif(name, video, step)
          frame = video[len(video) // 2]
          self._writer.add_image(name, frame, step, dataformats='HWC')
    self._writer.flush()

  def _write_gif(self, name, video, step):
    try:
      from PIL import Image
    except ImportError:
      return
    from . import path as pathlib
    outdir = pathlib.Path(self._logdir) / 'videos'
    outdir.mkdirs()
    frames = [Image.fromarray(f) for f in video]
    safe = name.replace('/', '_')
    filename = str(outdir / f'{safe}_{step}.gif')
    frames[0].save(
        filename, save_all=True, append_images=frames[1:],
        duration=int(1000 / self._fps), loop=0)


class MLFlowOutput:

  def __init__(self, run_name=None, resume_id=None, config=None):
    import mlflow
    self._mlflow = mlflow
    self._setup(run_name, resume_id, config)

  def __call__(self, summaries):
    bystep = {}
    for step, name, value in summaries:
      if len(value.shape) == 0:
        bystep.setdefault(step, {})[name.replace('/', '_')] = float(value)
    for step, metrics in bystep.items():
      self._mlflow.log_metrics(metrics, step=step)

  def _setup(self, run_name, resume_id, config):
    tracking_uri = None
    run_name = run_name or datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
    if resume_id:
      runs = self._mlflow.search_runs(
          None, f'tags.resume_id="{resume_id}"')
      if len(runs):
        run_id = runs['run_id'].iloc[0]
        self._mlflow.start_run(run_name=run_name, run_id=run_id)
        return
    tags = {'resume_id': resume_id or ''}
    self._mlflow.start_run(run_name=run_name, tags=tags)
    if config:
      for key, value in config.flat.items():
        self._mlflow.log_param(key.replace('/', '_'), value)
