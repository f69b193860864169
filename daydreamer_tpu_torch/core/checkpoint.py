"""Attribute-registration checkpointer (reference: embodied/core/checkpoint.py:7-69).

Any object exposing ``save()/load()`` can be registered as an attribute; all
payloads are written atomically as one pickle file stamped with a timestamp.
``load_or_save()`` bootstraps fresh runs. The saved agent payload is a flat
{name: ndarray} dict, so checkpoints double as the actor<->learner weight
sync channel in the async run modes (reference: embodied/run/learning.py:75-77).
"""

import pickle
import time

from . import path as pathlib


class Checkpoint:

  def __init__(self, filename=None, log=True):
    self._filename = filename and pathlib.Path(filename)
    self._log = log
    self._values = {}

  def __setattr__(self, name, value):
    if name.startswith('_'):
      return super().__setattr__(name, value)
    has_load = hasattr(value, 'load') and callable(value.load)
    has_save = hasattr(value, 'save') and callable(value.save)
    if not (has_load and has_save):
      message = f"Checkpoint entry '{name}' must implement save() and load()."
      raise ValueError(message)
    self._values[name] = value

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      return self._values[name]
    except KeyError:
      raise AttributeError(name)

  def exists(self, filename=None):
    assert self._filename or filename
    filename = pathlib.Path(filename or self._filename)
    return filename.exists()

  def load_or_save(self):
    if self.exists():
      self.load()
    else:
      self.save()

  def save(self, filename=None):
    assert self._filename or filename
    filename = pathlib.Path(filename or self._filename)
    self._log and print(f'Writing checkpoint: {filename}')
    data = {k: v.save() for k, v in self._values.items()}
    data['_timestamp'] = time.time()
    filename.parent.mkdirs()
    # Write-then-rename for atomicity so concurrent readers (the actor
    # polling the learner's agent.pkl) never observe a partial file.
    tmp = pathlib.Path(str(filename) + '.tmp')
    with tmp.open('wb') as f:
      pickle.dump(data, f)
    try:
      import os
      os.replace(str(tmp), str(filename))
    except OSError:
      tmp.copy(filename)
      tmp.remove()

  def load(self, filename=None, keys=None):
    assert self._filename or filename
    filename = pathlib.Path(filename or self._filename)
    with filename.open('rb') as f:
      data = pickle.load(f)
    keys = keys or self._values.keys()
    for key in keys:
      if key.startswith('_'):
        continue
      self._values[key].load(data[key])
    age = time.time() - data.get('_timestamp', time.time())
    self._log and print(f'Loaded checkpoint: {filename} (age {age:.0f}s)')
    # Unlike the reference (which returned None and thus never logged the
    # checkpoint age, reference: embodied/run/acting.py:87-89), return the age
    # so callers can track weight staleness.
    return age
