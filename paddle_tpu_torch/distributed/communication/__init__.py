"""paddle.distributed.communication (counterpart of
paddle_tpu/distributed/communication/): the collectives of
distributed/collective.py under their communication names, with the
``stream`` variants. ``all_reduce``, ``reduce_scatter`` and ``alltoall``
take ``compress="int8" | "bf16" | None`` (collective.py's docstring has
the wire forms and the error bound)."""
from ..collective import (  # noqa: F401
    ReduceOp, Group, new_group, get_group, destroy_process_group,
    all_reduce, all_gather, all_gather_object, reduce, reduce_scatter,
    broadcast, scatter, alltoall, all_to_all, alltoall_single, send, recv,
    isend, irecv, batch_isend_irecv, P2POp, barrier, wait, stream)

__all__ = ["ReduceOp", "Group", "new_group", "get_group",
           "destroy_process_group", "all_reduce", "all_gather",
           "all_gather_object", "reduce", "reduce_scatter", "broadcast",
           "scatter", "alltoall", "all_to_all", "alltoall_single", "send",
           "recv", "isend", "irecv", "batch_isend_irecv", "P2POp",
           "barrier", "wait", "stream"]
