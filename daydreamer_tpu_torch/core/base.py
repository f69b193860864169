"""Framework contracts: Agent, Env, Wrapper, Replay.

These are duck-typed protocols rather than enforced ABCs; concrete classes
override the methods they support and inherit loud errors for the rest.
Capability parity with the reference interfaces (embodied/core/base.py:1-110).

Data model conventions shared by every component:

* A *transition* is a flat dict of numpy arrays. Environments must emit the
  boolean keys ``is_first`` (episode began at this step), ``is_last`` (episode
  ended at this step), and ``is_terminal`` (the end was a true termination
  rather than a time limit). Most envs also emit ``reward`` and one or more
  observation keys such as ``image``.
* Action dicts must contain ``action`` plus the boolean ``reset`` signal.
* Any key beginning with ``log_`` carries diagnostics for the logger only and
  is never fed to the agent or stored for training.
"""


def _todo(description):
  """Build a method body that reports the expected signature when called."""

  def method(self, *args, **kwargs):
    raise NotImplementedError(
        f'{type(self).__name__} does not implement: {description}')

  return method


class Agent:
  """Learning algorithm contract consumed by the run modes.

  ``configs`` maps names of config blocks (from the agent's YAML file) to
  nested dicts; the CLI merges blocks selected via ``--configs``.
  """

  configs = {}

  def __init__(self, obs_space, act_space, step, config):
    pass

  policy = _todo("policy(obs, state=None, mode='train') -> (acts, state)")
  train = _todo('train(data, state=None) -> (outs, state, metrics)')
  report = _todo('report(data) -> metrics')
  dataset = _todo('dataset(generator_fn) -> batch iterator')
  save = _todo('save() -> checkpoint payload')
  load = _todo('load(payload) -> None')


class Env:
  """Environment contract: dict spaces in, dict transitions out."""

  @property
  def obs_space(self):
    # Must include is_first/is_last/is_terminal (see module docstring).
    raise NotImplementedError('obs_space -> {name: Space}')

  @property
  def act_space(self):
    # Must include action and reset.
    raise NotImplementedError('act_space -> {name: Space}')

  step = _todo('step(action_dict) -> transition dict')
  render = _todo('render() -> image array')

  def close(self):
    pass

  def __len__(self):
    # Single envs report 0; batched envs report their lane count.
    return 0

  def __bool__(self):
    # A length of zero must not make a single env falsy.
    return True

  def __repr__(self):
    name = type(self).__name__
    return f'{name}<lanes={len(self)} obs={self.obs_space} act={self.act_space}>'


class Wrapper:
  """Transparent env decorator: unknown attributes resolve on the wrapped env."""

  def __init__(self, env):
    self.env = env

  def __getattr__(self, name):
    # Dunder/private lookups must fail fast so copy/pickle protocols work.
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      return getattr(self.env, name)
    except AttributeError:
      # Distinguish "wrapped env lacks it" from ordinary attribute misses.
      raise ValueError(name)

  def __len__(self):
    return len(self.env)

  def __bool__(self):
    return bool(self.env)


class Replay:
  """Experience buffer contract: ingestion, sampling, and persistence."""

  add = _todo('add(transition, worker=0) -> None')
  add_traj = _todo('add_traj(trajectory) -> None')
  dataset = _todo('dataset() -> generator of chunk dicts')

  def __len__(self):
    raise NotImplementedError('len(replay) -> stored step count')

  @property
  def stats(self):
    raise NotImplementedError('stats -> metrics dict')

  def prioritize(self, keys, priorities):
    # Per-sample priority feedback; a no-op for uniform samplers.
    pass

  def save(self):
    pass

  def load(self, data):
    pass
