"""Command-line flags typed against a Config.

Capability parity with the reference parser (reference:
embodied/core/flags.py:7-99): ``--key value...``, ``--key=value``, regex
pattern flags that fan out over matching config keys, and ``parse_known``
for layered parsing where unrecognized flags pass through.

Parsing happens in two phases: argv is first grouped into (flag, values)
tokens, then each group is resolved against the config's flat key space and
coerced to the type of its default.
"""

import re
import sys

from .config import Config


def _tokenize(argv):
  """Group argv into (flag_name_or_None, [values]) tuples."""
  groups = []
  for arg in argv:
    if arg.startswith('--'):
      name, eq, inline = arg[2:].partition('=')
      groups.append([name, [inline] if eq else []])
    elif groups:
      groups[-1][1].append(arg)
    else:
      groups.append([None, [arg]])
  return groups


def _coerce(text, default, key):
  """Convert one string to the type of the config default."""
  if default is None:
    return text
  if isinstance(default, bool):
    if text not in ('True', 'False'):
      raise TypeError(f"Flag '{key}' must be True or False but got '{text}'.")
    return text == 'True'
  if isinstance(default, int):
    # Accept scientific notation (1e6) but reject true fractions.
    number = float(text)
    if number != int(number):
      raise TypeError(f"Flag '{key}' of type int got fractional {number}.")
    return int(number)
  return type(default)(text)


class Flags:

  def __init__(self, *args, **kwargs):
    self._config = Config(*args, **kwargs)

  def parse(self, argv=None, help_exits=True):
    config, leftover = self.parse_known(argv, help_exits)
    unmatched = [x for x in leftover if x.startswith('--')]
    if unmatched:
      raise ValueError(f"Flag '{unmatched[0]}' did not match any config keys.")
    if leftover:
      raise ValueError(f'Could not parse all arguments: {leftover}')
    return config

  def parse_known(self, argv=None, help_exits=False):
    if argv is None:
      argv = sys.argv[1:]
    if '--help' in argv:
      print('\nHelp: The available flags are:')
      print(self._config)
      help_exits and sys.exit()
    updates = {}
    leftover = []
    for name, values in _tokenize(argv):
      if name is None:
        leftover.extend(values)
        continue
      if '=' in name:  # A second '=' inside the value part of --k=v.
        leftover.append(f'--{name}')
        leftover.extend(values)
        continue
      targets = self._resolve(name)
      if not targets:
        leftover.append(f'--{name}')
        leftover.extend(values)
        continue
      if not values:
        raise ValueError(f"Flag '--{name}' was not followed by any values.")
      for target in targets:
        updates[target] = self._typed(target, values)
    return self._config.update(updates), leftover

  def _resolve(self, name):
    """Map a flag name to the config keys it addresses."""
    if self._config.IS_PATTERN.match(name):
      matcher = re.compile(name)
      return sorted(k for k in self._config.flat if matcher.fullmatch(k))
    return [name] if name in self._config.flat else []

  def _typed(self, key, values):
    default = self._config[key]
    if isinstance(default, (tuple, list)):
      if len(values) == 1 and ',' in values[0]:
        values = values[0].split(',')
      proto = default[0] if len(default) else ''
      return tuple(_coerce(v, proto, key) for v in values)
    if len(values) != 1:
      raise ValueError(
          f"Flag '--{key}' expects one value but got {len(values)}.")
    return _coerce(values[0], default, key)
