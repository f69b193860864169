"""Immutable, typed, nested configuration.

Capability parity with the reference config system (embodied/core/config.py):
nested dicts are addressable by dotted keys, ``update()`` type-checks new
values against the old ones (with numeric coercion), and update keys may be
regular expressions (e.g. ``.*\\.lr``) that fan out over every matching leaf.
Configs round-trip through YAML and JSON.

Internally a Config is a flat ``{dotted_key: leaf}`` table; the nested dict
view (the ``dict`` base class content) is derived from it, not the other way
around.
"""

import json
import re


SEP = '.'

# Characters allowed in literal (non-pattern) key components.
_LITERAL = re.compile(r'[A-Za-z0-9_.-]+')


def is_pattern(key):
  """A key is a regex pattern iff it uses characters outside the literal set."""
  return _LITERAL.fullmatch(key) is None


def leaves(mapping, trail=()):
  """Yield (path_tuple, value) for every leaf of a nested mapping.

  Components are kept verbatim (they may themselves contain dots or regex
  syntax); callers join them with SEP to form dotted keys.
  """
  for name, value in mapping.items():
    path = trail + (name,)
    if isinstance(value, dict):
      yield from leaves(value, path)
    else:
      yield path, value


def treeify(flat):
  """Invert a flat {dotted_key: leaf} table into a nested dict."""
  tree = {}
  for dotted, value in flat.items():
    *branch, leaf = dotted.split(SEP)
    node = tree
    for name in branch:
      node = node.setdefault(name, {})
    node[leaf] = value
  return tree


def _check_leaf(dotted, value):
  """Normalize one leaf: tuples for sequences, homogeneous primitive types."""
  if isinstance(value, (list, tuple)):
    items = tuple(value)
    if not items:
      raise TypeError(
          f"Key '{dotted}': empty sequences are not allowed because their "
          'element type would be ambiguous.')
    kind = type(items[0])
    if kind not in (str, float, int, bool):
      raise TypeError(
          f"Key '{dotted}': sequence elements must be primitives, "
          f'got {kind.__name__}.')
    if any(not isinstance(item, kind) for item in items):
      raise TypeError(f"Key '{dotted}': mixed-type sequences are not allowed.")
    return items
  if value is not None and not isinstance(value, (str, float, int, bool)):
    raise TypeError(
        f"Key '{dotted}': unsupported leaf type {type(value).__name__}.")
  return value


def _coerce(dotted, old, new):
  """Convert `new` to the type of `old`, rejecting lossy conversions."""
  try:
    if isinstance(old, bool) and isinstance(new, str):
      if new not in ('True', 'False'):
        raise ValueError(new)
      return new == 'True'
    if isinstance(old, int) and not isinstance(old, bool):
      as_float = float(new)
      if as_float != int(as_float):
        raise ValueError(f'fractional value {new}')
      return int(as_float)
    if isinstance(old, (list, tuple)):
      items = new if isinstance(new, (list, tuple)) else (new,)
      proto = old[0] if len(old) else ''
      return tuple(_coerce(dotted, proto, item) for item in items)
    return type(old)(new)
  except (TypeError, ValueError) as e:
    raise TypeError(
        f"Key '{dotted}': cannot convert {new!r} to "
        f'{type(old).__name__} (current value {old!r}): {e}')


class Config(dict):

  # Kept as an attribute for backwards compatibility with callers that
  # probe `config.IS_PATTERN`.
  IS_PATTERN = re.compile(r'.*[^A-Za-z0-9_.-].*')
  SEP = SEP

  def __init__(self, *args, **kwargs):
    flat = {}
    for path, value in leaves(dict(*args, **kwargs)):
      dotted = SEP.join(path)
      if is_pattern(dotted):
        raise ValueError(f'Pattern keys are only allowed in update(): {dotted}')
      flat[dotted] = _check_leaf(dotted, value)
    object.__setattr__(self, '_leaves', flat)
    super().__init__(treeify(flat))

  @property
  def flat(self):
    return dict(self._leaves)

  def update(self, *args, **kwargs):
    table = dict(self._leaves)
    for path, value in leaves(dict(*args, **kwargs)):
      dotted = SEP.join(path)
      if is_pattern(dotted):
        # Literal components joined to a pattern are escaped, so a pattern
        # nested under a plain branch only matches inside that branch.
        source = r'\.'.join(
            part if is_pattern(part) else re.escape(part) for part in path)
        regex = re.compile(source)
        targets = [k for k in table if regex.fullmatch(k)]
      else:
        targets = [dotted] if dotted in table else []
      if not targets:
        raise KeyError(f'Unknown key or pattern {dotted}.')
      for target in targets:
        table[target] = _coerce(target, table[target], value)
    return type(self)(table)

  def save(self, filename):
    from . import path as pathlib
    filename = pathlib.Path(filename)
    if filename.suffix == '.json':
      filename.write(json.dumps(dict(self)))
    elif filename.suffix in ('.yml', '.yaml'):
      import yaml
      # JSON round-trip canonicalizes tuples and numpy scalars into plain
      # YAML-safe types.
      table = json.loads(json.dumps(dict(self)))
      with filename.open('w') as f:
        yaml.safe_dump(table, f, default_flow_style=False)
    else:
      raise NotImplementedError(filename.suffix)

  @classmethod
  def load(cls, filename):
    from . import path as pathlib
    filename = pathlib.Path(filename)
    if filename.suffix == '.json':
      return cls(json.loads(filename.read_text()))
    if filename.suffix in ('.yml', '.yaml'):
      import yaml
      return cls(yaml.safe_load(filename.read_text()))
    raise NotImplementedError(filename.suffix)

  # --- Read access -------------------------------------------------------

  def __getitem__(self, dotted):
    node = dict.__getitem__  # Bypass our own lookup for raw dict access.
    value = self
    for name in dotted.split(SEP):
      if not isinstance(value, dict):
        raise KeyError(dotted)
      try:
        value = node(value, name)
      except KeyError:
        raise KeyError(dotted)
    if isinstance(value, dict):
      return type(self)(value)
    return value

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name)

  def __contains__(self, dotted):
    try:
      self[dotted]
      return True
    except KeyError:
      return False

  # --- Immutability ------------------------------------------------------

  def __setattr__(self, name, value):
    if name.startswith('_'):
      return object.__setattr__(self, name, value)
    raise AttributeError(
        f'Config is immutable; use update() to change {name!r}.')

  def __setitem__(self, name, value):
    raise AttributeError(
        f'Config is immutable; use update() to change {name!r}.')

  # --- Misc protocols ----------------------------------------------------

  def __reduce__(self):
    return (type(self), (dict(self),))

  def __str__(self):
    rows = [
        (dotted + ':', _pretty(value), _typename(value))
        for dotted, value in self._leaves.items()]
    if not rows:
      return '\nConfig: (empty)'
    kwidth = max(len(r[0]) for r in rows)
    vwidth = max(len(r[1]) for r in rows)
    lines = ['\nConfig:']
    for key, value, kind in rows:
      lines.append(f'{key:<{kwidth}}  {value:<{vwidth}}  ({kind})')
    return '\n'.join(lines)


def _pretty(value):
  if isinstance(value, (list, tuple)):
    return '[' + ', '.join(_pretty(item) for item in value) + ']'
  return str(value)


def _typename(value):
  if isinstance(value, (list, tuple)):
    return _typename(value[0]) + 's'
  return type(value).__name__
