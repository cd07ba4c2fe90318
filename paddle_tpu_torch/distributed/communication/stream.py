"""paddle.distributed.communication.stream (counterpart of
paddle_tpu/distributed/communication/stream.py): the collective calls,
which return a task with ``sync_op=False``."""
from ..collective import stream as _ns

all_gather = _ns.all_gather
all_reduce = _ns.all_reduce
alltoall = _ns.alltoall
alltoall_single = _ns.alltoall_single
broadcast = _ns.broadcast
reduce = _ns.reduce
reduce_scatter = _ns.reduce_scatter
scatter = _ns.scatter
send = _ns.send
recv = _ns.recv

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "scatter", "send",
           "recv"]
