from .mesh import (
    make_mesh, replicated, batch_sharded, shard_batch, replicate)
from .distributed import initialize, is_main_process, host_local_batch
