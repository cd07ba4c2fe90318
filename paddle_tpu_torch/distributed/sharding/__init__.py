"""paddle.distributed.sharding (counterpart of
paddle_tpu/distributed/sharding/__init__.py): ``group_sharded_parallel``
over the ZeRO stages of fleet/meta_parallel/sharding_optimizer.py, and
``save_group_sharded_model``, whose files hold the whole, gathered state
(a collective: every rank of the sharding group calls it; rank 0 of the
group writes)."""
from __future__ import annotations

import os

from ..fleet.meta_parallel.sharding_optimizer import (
    DygraphShardingOptimizer, GroupShardedOptimizerStage2, GroupShardedStage2,
    GroupShardedStage3)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """level: 'os' (stage 1) | 'os_g' (stage 2) | 'p_g_os' (stage 3).
    Returns (model, optimizer, scaler)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"unknown level {level!r}: 'os', 'os_g' or "
                         f"'p_g_os'")
    for name, val in (("scaler", scaler), ("dp_group", dp_group),
                      ("exclude_layer", exclude_layer)):
        if val is not None:
            raise NotImplementedError(f"group_sharded_parallel({name}=...) "
                                      f"is not ported to the PyTorch "
                                      f"package yet")
    if level == "os":
        opt = DygraphShardingOptimizer(optimizer, group=group,
                                       offload=offload)
        return model, opt, scaler
    opt = GroupShardedOptimizerStage2(optim=optimizer, group=group,
                                      offload=offload)
    if level == "os_g":
        model = GroupShardedStage2(model, opt, group=group,
                                   sync_buffers=sync_buffers,
                                   buffer_max_size=buffer_max_size)
        return model, opt, scaler
    model = GroupShardedStage3(model, opt, group=group,
                               sync_buffers=sync_buffers,
                               segment_size=segment_size)
    return model, opt, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Write ``output``/model.pdmodel (and model.pdopt with the optimizer)
    with the whole state."""
    from ...framework.io import save
    sd = model.state_dict()
    opt_sd = optimizer.state_dict() if optimizer is not None else None
    g = getattr(optimizer, "_sharding_group", None)
    if g is not None and g.rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(sd, os.path.join(output, "model.pdmodel"))
    if opt_sd is not None:
        save(opt_sd, os.path.join(output, "model.pdopt"))
