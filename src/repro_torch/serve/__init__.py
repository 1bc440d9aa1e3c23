"""Online GNN inference serving from the epoch-pinned training caches.

``GNNServer`` packs seed-vertex requests (``DeadlineBatcher``) into
fixed-shape micro-batches, samples and gathers them through the
``CliqueCache`` at a pinned cache epoch, and replies from one forward per
micro-batch; ``host_oracle_batch`` is the bitwise parity oracle.
"""
from repro_torch.serve.batcher import (FLUSH_CLOSE, FLUSH_DEADLINE, FLUSH_FULL,
                                       DeadlineBatcher, ServeRequest)
from repro_torch.serve.oracle import host_oracle_batch
from repro_torch.serve.server import GNNServer, ServeConfig, ServeResult

__all__ = ["GNNServer", "ServeConfig", "ServeResult", "DeadlineBatcher",
           "ServeRequest", "host_oracle_batch", "FLUSH_FULL",
           "FLUSH_DEADLINE", "FLUSH_CLOSE"]
