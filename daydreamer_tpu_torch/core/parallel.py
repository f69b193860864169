"""Transparent RPC proxy over a Worker (reference: embodied/core/parallel.py:6-48).

Wraps an object constructor in a Worker; method calls dispatch as promises,
attribute reads resolve synchronously. Used to run environment instances in
their own processes while the driver sees a normal object.
"""

import functools

from .worker import Worker


class Parallel:

  def __init__(self, ctor, strategy='process', daemon=False):
    self._worker = Worker(strategy, daemon)
    self._kinds = {}
    self._promise = self._worker.run(self._construct, ctor)
    self._promise()

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    if name not in self._kinds:
      self._kinds[name] = self._worker.run(self._check_attr, name)()
    if self._kinds[name] == 'method':
      return functools.partial(self._call, name)
    else:
      return self._worker.run(self._get_attr, name)()

  def __len__(self):
    return self._worker.run(self._get_len)()

  def close(self):
    try:
      self._worker.run(self._close_obj)()
    except Exception:
      pass
    self._worker.close()

  def _call(self, name, *args, **kwargs):
    return self._worker.run(self._call_method, name, args, kwargs)

  @staticmethod
  def _construct(state, ctor):
    state['obj'] = ctor()
    return True

  @staticmethod
  def _check_attr(state, name):
    attr = getattr(state['obj'], name)
    return 'method' if callable(attr) else 'attr'

  @staticmethod
  def _get_attr(state, name):
    return getattr(state['obj'], name)

  @staticmethod
  def _get_len(state):
    return len(state['obj'])

  @staticmethod
  def _call_method(state, name, args, kwargs):
    return getattr(state['obj'], name)(*args, **kwargs)

  @staticmethod
  def _close_obj(state):
    obj = state.get('obj')
    if obj is not None and hasattr(obj, 'close'):
      obj.close()
    return True
