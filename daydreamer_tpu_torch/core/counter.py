"""Mutable step counter that behaves like an int in comparisons/arithmetic.

Capability parity with the reference counter (embodied/core/counter.py); the
comparison operators are derived via functools.total_ordering.
"""

import functools


@functools.total_ordering
class Counter:

  __slots__ = ('value',)

  def __init__(self, start=0):
    self.value = int(start)

  def increment(self, amount=1):
    self.value += amount

  def save(self):
    return self.value

  def load(self, value):
    self.value = value

  def __int__(self):
    return int(self.value)

  __index__ = __int__

  def __repr__(self):
    return f'Counter({self.value})'

  def __eq__(self, other):
    return int(self) == other

  def __lt__(self, other):
    return int(self) < other

  def __hash__(self):
    return hash(int(self))

  def __add__(self, other):
    return int(self) + other

  def __radd__(self, other):
    return other + int(self)

  def __sub__(self, other):
    return int(self) - other

  def __mod__(self, other):
    return int(self) % other
