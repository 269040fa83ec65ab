"""Multi-process embedding parameter servers (port of ``repro/net``, paper
§3-§4).

Persia runs NN workers, embedding workers and the embedding PS as separate
services; this package is that tier on one box, with real processes:

* :mod:`repro_torch.net.wire`   — length-prefixed framing + an array-tree
  codec (the checkpoint blob layout on a socket) + the numpy blockscale
  wire format, matching the CUDA codec bit for bit. Byte-compatible with
  the JAX package's.
* :mod:`repro_torch.net.rpc`    — pipelined request/response RPC with
  per-request timeouts, bounded retry/backoff, reconnect, op coalescing
  and at-most-once replay suppression for mutating ops.
* :mod:`repro_torch.net.ps_server` — the PS process: the port's dense or
  host_lru backend, on the card by default, behind the RPC surface, with a
  put spool so a killed shard loses only its in-flight puts.
* :mod:`repro_torch.net.remote` — the client side: ``RemoteBackend``
  implements the ``EmbeddingBackend`` protocol over RPC (the trainer keeps
  the plan, the bag launch and the sum-only put launch; the PS applies),
  and ``RemoteShardedBackend`` routes a table over k PS processes through
  the same machinery as the in-process ``ShardedBackend``.
* :mod:`repro_torch.net.elastic` — heartbeats, failure detection and live
  elastic membership (a dead shard's logical rows reshard onto survivors
  mid-run, reusing the N->M checkpoint reshard path).

The JAX package also exports ``reset_trainer_jit``; the port's eager
trainer has no compiled program to reset, so it has no such function.
"""

from repro_torch.net.rpc import (PSUnavailableError, RpcClient, RpcError,
                                 RpcServer)
from repro_torch.net.remote import (RemoteBackend, RemoteShardedBackend,
                                    connect_remote_backends)
from repro_torch.net.elastic import (ClusterDeadError, ElasticPSCluster,
                                     HeartbeatMonitor, PSMember,
                                     is_ps_failure)

__all__ = [
    "PSUnavailableError", "RpcClient", "RpcError", "RpcServer",
    "RemoteBackend", "RemoteShardedBackend", "connect_remote_backends",
    "ClusterDeadError", "ElasticPSCluster", "HeartbeatMonitor", "PSMember",
    "is_ps_failure",
]
