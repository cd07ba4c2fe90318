"""The model zoo's choice between the tensor-parallel layers and the
dense ones (counterpart of paddle_tpu/models/_tp_utils.py)."""
from __future__ import annotations

from torch import nn

from ..nn.layer.common import linear

__all__ = ["parallel_linears", "mp_group"]


def mp_group(cfg):
    """The mp group a tensor-parallel model runs over (fleet's, or none
    for one rank); None for a dense model."""
    if not cfg.tensor_parallel:
        return None
    from ..distributed.fleet.meta_parallel.mp_layers import _mp_group
    return _mp_group(None)


def parallel_linears(cfg, device, dtype, generator=None, has_bias=False):
    """(column_factory, row_factory): the fleet mp layers when
    cfg.tensor_parallel (Column's output stays mp-sharded, Row takes
    mp-sharded input: the Megatron pairing), dense Linears otherwise
    (paddle's initialisers from ``generator``, or uninitialised when it
    is None: the model draws them). With cfg.sequence_parallel the
    tensor-parallel pair is the sequence-parallel one: Column takes
    sequence-sharded input, Row gives it. A factory takes (in, out) and,
    for a column, ``fused_parts`` (a fused q/k/v projection splits each
    part)."""
    if cfg.tensor_parallel:
        from ..distributed.fleet.meta_parallel.mp_layers import (
            ColumnParallelLinear, RowParallelLinear)
        column, row_cls = ColumnParallelLinear, RowParallelLinear
        if getattr(cfg, "sequence_parallel", False):
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                ColumnSequenceParallelLinear, RowSequenceParallelLinear)
            column = ColumnSequenceParallelLinear
            row_cls = RowSequenceParallelLinear

        def col(i, o, fused_parts=1):
            return column(
                i, o, has_bias=has_bias, gather_output=False, device=device,
                dtype=dtype, generator=generator, _fused_parts=fused_parts)

        def row(i, o):
            return row_cls(i, o, has_bias=has_bias, input_is_parallel=True,
                           device=device, dtype=dtype, generator=generator)
        return col, row

    def dense(i, o, fused_parts=1):
        if generator is None:
            return nn.utils.skip_init(nn.Linear, i, o, bias=has_bias,
                                      device=device, dtype=dtype)
        return linear(i, o, device, dtype, generator, bias=has_bias)
    return dense, dense
