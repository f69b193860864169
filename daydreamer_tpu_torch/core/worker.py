"""Process/thread workers running a cloudpickle-RPC message loop.

Parity with reference workers (reference: embodied/core/worker.py:19-141):
functions ship via cloudpickle over a mp.Pipe, results come back as
promises, per-process initializers run once in each worker, and close()
hard-kills stragglers. Strategies: 'process' (spawn), 'thread', 'none'
(inline, for debugging).
"""

import atexit
import enum
import os
import queue as queuelib
import sys
import threading
import time
import traceback

try:
  import cloudpickle
except ImportError:
  cloudpickle = None


class Message(enum.Enum):
  RUN = 2
  RESULT = 3
  STOP = 4
  ERROR = 5


class Worker:

  initializers = []

  def __init__(self, strategy='thread', daemon=False, state=None):
    self._strategy = strategy
    if strategy == 'process':
      import multiprocessing
      context = multiprocessing.get_context('spawn')
      self._pipe, pipe = context.Pipe()
      initializers = cloudpickle.dumps(self.initializers)
      self._process = context.Process(
          target=self._loop, args=(pipe, initializers), daemon=daemon)
      self._process.start()
    elif strategy == 'thread':
      self._queue = queuelib.Queue()
      self._results = queuelib.Queue()
      self._thread = threading.Thread(
          target=self._thread_loop, args=(state or {},), daemon=True)
      self._thread.start()
    elif strategy == 'none':
      self._state = state or {}
    else:
      raise NotImplementedError(strategy)
    self._counter = 0
    atexit.register(self.close)

  def run(self, function, *args):
    self._counter += 1
    ticket = self._counter
    if self._strategy == 'process':
      payload = cloudpickle.dumps((function, args))
      self._pipe.send((Message.RUN, ticket, payload))
      return Promise(self._receive, ticket)
    elif self._strategy == 'thread':
      self._queue.put((Message.RUN, ticket, (function, args)))
      return Promise(self._receive_thread, ticket)
    elif self._strategy == 'none':
      try:
        result = function(self._state, *args)
        return Promise(lambda _: result, ticket)
      except Exception as e:
        return Promise(self._raise, e)

  def close(self):
    try:
      atexit.unregister(self.close)
    except Exception:
      pass
    if self._strategy == 'process':
      try:
        self._pipe.send((Message.STOP, self._counter + 1, None))
        self._process.join(0.3)
        if self._process.exitcode is None:
          try:
            os.kill(self._process.pid, 9)
          except ProcessLookupError:
            pass
      except (BrokenPipeError, OSError, AttributeError):
        pass
    elif self._strategy == 'thread':
      try:
        self._queue.put((Message.STOP, self._counter + 1, None))
        self._thread.join(0.3)
      except Exception:
        pass

  def _raise(self, e):
    raise e

  def _receive(self, ticket):
    # Process results arrive in submission order over the pipe.
    while True:
      message, result_ticket, payload = self._pipe.recv()
      if message == Message.ERROR:
        raise RuntimeError(payload)
      assert message == Message.RESULT, message
      if result_ticket == ticket:
        return payload
      # Tickets are issued in order and results return in order.
      assert result_ticket < ticket, (result_ticket, ticket)

  def _receive_thread(self, ticket):
    while True:
      message, result_ticket, payload = self._results.get()
      if message == Message.ERROR:
        raise RuntimeError(payload)
      assert message == Message.RESULT, message
      if result_ticket == ticket:
        return payload
      assert result_ticket < ticket, (result_ticket, ticket)

  def _thread_loop(self, state):
    for initializer in self.initializers:
      initializer()
    while True:
      message, ticket, payload = self._queue.get()
      if message == Message.STOP:
        return
      assert message == Message.RUN, message
      function, args = payload
      try:
        result = function(state, *args)
        self._results.put((Message.RESULT, ticket, result))
      except Exception:
        self._results.put(
            (Message.ERROR, ticket, traceback.format_exc()))
        return

  @staticmethod
  def _loop(pipe, initializers):
    try:
      for initializer in cloudpickle.loads(initializers):
        initializer()
      state = {}
      while True:
        if not pipe.poll(0.1):
          continue  # Wake up for keyboard interrupts.
        message, ticket, payload = pipe.recv()
        if message == Message.STOP:
          return
        assert message == Message.RUN, message
        function, args = cloudpickle.loads(payload)
        result = function(state, *args)
        pipe.send((Message.RESULT, ticket, result))
    except (EOFError, KeyboardInterrupt):
      return
    except Exception:
      try:
        pipe.send((Message.ERROR, 0, traceback.format_exc()))
      except Exception:
        pass
      return
    finally:
      try:
        pipe.close()
      except Exception:
        pass


class Promise:

  def __init__(self, receive, ticket):
    self._receive = receive
    self._ticket = ticket
    self._done = False
    self._result = None

  def __call__(self):
    if not self._done:
      self._result = self._receive(self._ticket)
      self._done = True
    return self._result
