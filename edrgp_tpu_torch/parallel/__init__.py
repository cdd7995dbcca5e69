"""Multi-device layer: process groups, meshes, sharded steps, liveness.

The port of :mod:`edrgp_tpu.parallel` onto ``torch.distributed``: NCCL on
the card, gloo on the CPU.  Start each rank with :func:`initialize` (or
:func:`~edrgp_tpu_torch.parallel.distributed.spawn` for ranks on this
host), lay the ranks out with :func:`make_mesh`, and pass each sharded
function this rank's slab (:func:`shard_along`, :func:`shard_rows`).
"""

from .distributed import (assert_replicas_agree, barrier, checksum,
                          initialize, spawn)
from .exact_sharded import (make_sharded_nlml_value_and_grad, shard_rows,
                            sharded_nlml_value_and_grad)
from .heartbeat import (StallWatchdog, read_heartbeats, stale_peers,
                        write_heartbeat)
from .mesh import (factor_devices, make_hybrid_mesh, make_mesh,
                   shard_along)
from .sharded import (distributed_systematic_resample, make_sharded_svgp_step,
                      run_sharded_nuts, run_sharded_smc_stage)

__all__ = [
    "make_mesh", "factor_devices", "shard_along",
    "make_sharded_svgp_step", "run_sharded_nuts", "run_sharded_smc_stage",
    "distributed_systematic_resample",
    "make_sharded_nlml_value_and_grad", "sharded_nlml_value_and_grad",
    "shard_rows",
    "StallWatchdog", "write_heartbeat", "read_heartbeats", "stale_peers",
    "make_hybrid_mesh", "initialize", "barrier", "checksum",
    "assert_replicas_agree", "spawn",
]
