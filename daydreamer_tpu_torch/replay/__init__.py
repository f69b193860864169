from .stores import (
    RAMStore, DiskStore, CkptRAMStore, Stats, StoreServer, StoreClient)
from .fixed_length import FixedLength
from .consecutive import Consecutive
from .dispatch import Dispatch

try:
  from .prioritized import Prioritized
  from .priorities import Priorities
except ImportError:
  pass
