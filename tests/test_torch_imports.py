"""The port's import rule: `daydreamer_tpu_torch/` and `chip_smoke.py`
import neither JAX nor the JAX package `daydreamer_tpu`, the port imports
nothing of the repository's root `scripts/` package, and the port's native
build writes only into its own build directory."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / 'daydreamer_tpu_torch'


def _forbidden(name):
  top = name.split('.')[0]
  return (top.startswith(('jax', 'daydreamer_tpu'))
          and not top.endswith('_torch'))


def _sources():
  return sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']


# The port's copies of the repository's run scripts (beside the tooling).
RUN_SCRIPTS = ('scores', 'async_soak', 'train_a1_curve', 'train_dmc_curve',
               'train_short_a1', 'provenance')


def _imports(path):
  """(line, module) of every absolute import of `path`, at any depth (the
  lazy ones inside functions too)."""
  for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield node.lineno, alias.name
    elif isinstance(node, ast.ImportFrom) and not node.level:
      yield node.lineno, node.module


def test_forbidden_name_rule():
  for name in ('jax', 'jax.numpy', 'jaxlib', 'daydreamer_tpu',
               'daydreamer_tpu.envs', 'daydreamer_tpu_other'):
    assert _forbidden(name), name
  for name in ('daydreamer_tpu_torch', 'daydreamer_tpu_torch.envs', 'torch',
               'numpy', 'json'):
    assert not _forbidden(name), name


def test_sources_import_no_jax():
  """Every import statement of every source, at any depth (the lazy ones
  inside functions too)."""
  sources = _sources()
  assert len(sources) > 100 and (PORT / 'envs' / 'a1.py') in sources
  assert PORT / 'agents' / 'dreamer' / 'expl.py' in sources
  assert PORT / 'imitation' / 'ppo.py' in sources
  for script in ('profile_train', 'policy_latency', *RUN_SCRIPTS):
    assert PORT / 'scripts' / f'{script}.py' in sources
  bad = [(str(path.relative_to(ROOT)), line, name)
         for path in sources for line, name in _imports(path)
         if _forbidden(name)]
  assert not bad, bad


def test_port_imports_no_root_scripts():
  """No port module (nor `chip_smoke.py`) imports the root `scripts`
  package or a module of it, nor names one to run (`-m scripts.NAME`): the
  port keeps its own copies."""
  bad = [(str(path.relative_to(ROOT)), line, name)
         for path in _sources() for line, name in _imports(path)
         if name.split('.')[0] == 'scripts']
  for path in _sources():
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
      if (isinstance(node, ast.Constant) and isinstance(node.value, str)
          and node.value.startswith('scripts.')):
        bad.append((str(path.relative_to(ROOT)), node.lineno, node.value))
  assert not bad, bad


def test_modules_load_without_jax(tmp_path):
  """The host-side layers, imitation and the tooling scripts import in a
  fresh interpreter without pulling in JAX, the JAX package or MuJoCo
  (which the card's machine lacks: the A1 sim imports it at its first
  use); building the native libraries writes only under
  `daydreamer_tpu_torch/native/_build/`."""
  native = PORT / 'native'
  before = {p: p.stat().st_mtime_ns for p in native.iterdir() if p.is_file()}
  script = (
      'import sys\n'
      'import daydreamer_tpu_torch.envs, daydreamer_tpu_torch.control\n'
      'import daydreamer_tpu_torch.native\n'
      'import daydreamer_tpu_torch.replay.batcher\n'
      'import daydreamer_tpu_torch.imitation\n'
      'import daydreamer_tpu_torch.scripts.profile_train\n'
      'import daydreamer_tpu_torch.scripts.policy_latency\n'
      'from daydreamer_tpu_torch.scripts import (\n'
      '    scores, async_soak, train_a1_curve, train_dmc_curve,\n'
      '    train_short_a1, provenance)\n'
      'from daydreamer_tpu_torch.native import load\n'
      'from daydreamer_tpu_torch.native.build import SOURCES\n'
      'libs = [str(load(name)._name) for name in SOURCES]\n'
      'mods = [m for m in sys.modules if m.split(".")[0] in\n'
      '        ("jax", "jaxlib", "daydreamer_tpu", "mujoco", "scripts",\n'
      '         "matplotlib")]\n'
      'print(repr((mods, libs)))\n')
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300,
                       check=True).stdout
  mods, libs = ast.literal_eval(out.strip().splitlines()[-1])
  assert not mods, mods
  for lib in libs:
    assert pathlib.Path(lib).parent == native / '_build', lib
  after = {p: p.stat().st_mtime_ns for p in native.iterdir() if p.is_file()}
  assert after == before  # Nothing written next to the sources.
  assert not list(native.glob('*.so'))
  assert not list(tmp_path.iterdir())
