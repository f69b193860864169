"""Filesystem paths with pluggable storage backends.

Fills the role of the reference's URI path layer (reference:
embodied/core/path.py:8-207) with a different shape: instead of one
subclass per filesystem, ``Path`` is a single immutable value type.  All
path *algebra* (join, parent, name, suffix) is plain string manipulation
on the ``scheme://key`` form, and every *IO* call is routed at call time
to a storage backend picked by scheme.  Backends are tiny objects with an
``open/exists/isfile/isdir/makedirs/unlink/deltree/copy/list`` surface:
``local`` wraps the ``os`` module; every other scheme (``gs://``,
``s3://``, ...) is served by one fsspec-backed adapter when fsspec is
importable.  New schemes plug in via ``set_backend(scheme, backend)``.
"""

import fnmatch
import os
import posixpath
import shutil


class LocalBackend:
  """Storage operations on the local filesystem (the `os` module)."""

  def open(self, path, mode):
    return open(path, mode)

  def exists(self, path):
    return os.path.exists(path)

  def isfile(self, path):
    return os.path.isfile(path)

  def isdir(self, path):
    return os.path.isdir(path)

  def makedirs(self, path):
    os.makedirs(path, exist_ok=True)

  def unlink(self, path):
    os.remove(path)

  def deltree(self, path):
    shutil.rmtree(path)

  def copy(self, src, dst):
    if os.path.isdir(src):
      shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
      shutil.copy(src, dst)

  def list(self, path):
    try:
      return os.listdir(path)
    except FileNotFoundError:
      return []

  def resolve(self, path):
    return os.path.abspath(os.path.expanduser(path))


class FsspecBackend:
  """One adapter for every fsspec-supported remote scheme (gs, s3, ...)."""

  def __init__(self, scheme):
    import fsspec
    self._fs = fsspec.filesystem(scheme)
    self._scheme = scheme

  def _key(self, path):
    return path.split('://', 1)[-1]

  def open(self, path, mode):
    return self._fs.open(self._key(path), mode)

  def exists(self, path):
    return self._fs.exists(self._key(path))

  def isfile(self, path):
    return self._fs.isfile(self._key(path))

  def isdir(self, path):
    return self._fs.isdir(self._key(path))

  def makedirs(self, path):
    self._fs.makedirs(self._key(path), exist_ok=True)

  def unlink(self, path):
    self._fs.rm(self._key(path))

  def deltree(self, path):
    self._fs.rm(self._key(path), recursive=True)

  def copy(self, src, dst):
    self._fs.copy(self._key(src), self._key(dst), recursive=True)

  def list(self, path):
    return [posixpath.basename(p) for p in self._fs.ls(
        self._key(path), detail=False)]

  def resolve(self, path):
    return path


_BACKENDS = {'': LocalBackend(), 'file': LocalBackend()}


def set_backend(scheme, backend):
  """Install `backend` for `scheme` (e.g. a fake filesystem in tests)."""
  _BACKENDS[scheme] = backend


def get_backend(scheme):
  if scheme not in _BACKENDS:
    try:
      _BACKENDS[scheme] = FsspecBackend(scheme)
    except (ImportError, ValueError):
      raise NotImplementedError(
          f'No storage backend for scheme {scheme!r} '
          '(install fsspec for remote filesystems).') from None
  return _BACKENDS[scheme]


def _canonical(text):
  """Normalize to `scheme, key` with no trailing slash and no './' noise."""
  text = str(text)
  scheme, sep, key = text.partition('://')
  if not sep:
    scheme, key = '', os.path.expanduser(text)
  while key.startswith('./'):
    key = key[2:]
  if len(key) > 1:
    key = key.rstrip('/') or '/'
  return scheme, key or '.'


class Path:
  """Immutable `scheme://key` path value; IO delegated per scheme."""

  __slots__ = ('_scheme', '_key')

  def __init__(self, path='.'):
    if isinstance(path, Path):
      self._scheme, self._key = path._scheme, path._key
    else:
      self._scheme, self._key = _canonical(path)

  # -- algebra (pure string manipulation) --

  def __str__(self):
    if self._scheme:
      return f'{self._scheme}://{self._key}'
    return self._key

  def __repr__(self):
    return f'Path({str(self)})'

  def __fspath__(self):
    return str(self)

  def __truediv__(self, part):
    return type(self)(f'{str(self)}/{str(part)}')

  def __eq__(self, other):
    return str(self) == str(other)

  def __lt__(self, other):
    return str(self) < str(other)

  def __hash__(self):
    return hash(str(self))

  def __reduce__(self):
    return (type(self), (str(self),))

  @property
  def parent(self):
    head = posixpath.dirname(self._key)
    if self._scheme:
      return type(self)(f'{self._scheme}://{head}')
    return type(self)(head or ('/' if self._key.startswith('/') else '.'))

  @property
  def name(self):
    return posixpath.basename(self._key)

  @property
  def stem(self):
    return posixpath.splitext(self.name)[0]

  @property
  def suffix(self):
    return posixpath.splitext(self.name)[1]

  # -- IO (delegated to the scheme's backend) --

  @property
  def _backend(self):
    return get_backend(self._scheme)

  def open(self, mode='r'):
    return self._backend.open(str(self), mode)

  def read(self, mode='r'):
    with self.open(mode) as f:
      return f.read()

  def read_text(self):
    return self.read('r')

  def read_bytes(self):
    return self.read('rb')

  def write(self, content, mode='w'):
    with self.open(mode) as f:
      f.write(content)

  def exists(self):
    return self._backend.exists(str(self))

  def isfile(self):
    return self._backend.isfile(str(self))

  def isdir(self):
    return self._backend.isdir(str(self))

  def mkdirs(self):
    self._backend.makedirs(str(self))
    return self

  def remove(self):
    self._backend.unlink(str(self))

  def rmtree(self):
    self._backend.deltree(str(self))

  def copy(self, dest):
    self._backend.copy(str(self), str(Path(dest)))

  def glob(self, pattern):
    """Children of this directory matching `pattern` (non-recursive)."""
    for entry in self._backend.list(str(self)):
      if fnmatch.fnmatch(entry, pattern):
        yield self / entry

  def absolute(self):
    return type(self)(self._backend.resolve(str(self)))
