"""Mixture of experts on one device (counterpart of
paddle_tpu/incubate/distributed/models/moe).

Experts are stacked parameters [E, ...]. MoELayer dispatches in two ways:
``"capacity"`` (the GShard formulation: a static capacity buffer [E, C, H]
and batched products; routes past C drop) and ``"grouped"`` (dropless:
routes sorted by expert into tile-aligned groups, the expert products
through the grouped-matmul CUDA kernels of kernels/grouped_matmul.py, or
the quantized grouped kernel with ``expert_quant``). The expert-parallel
all-to-all exchange, fleet's stage-2 optimizer wrapper and the routing
telemetry are not ported.
"""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import ExpertMLP, MoELayer  # noqa: F401
