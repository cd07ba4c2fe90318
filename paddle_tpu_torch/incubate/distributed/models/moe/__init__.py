"""Mixture of experts (counterpart of
paddle_tpu/incubate/distributed/models/moe).

Experts are stacked parameters [E, ...]. MoELayer dispatches in two ways:
``"capacity"`` (the GShard formulation: a static capacity buffer [E, C, H]
and batched products; routes past C drop) and ``"grouped"`` (dropless:
routes sorted by expert into tile-aligned groups, the expert products
through the grouped-matmul CUDA kernels of kernels/grouped_matmul.py, or
the quantized grouped kernel with ``expert_quant``). Under expert
parallelism (``moe_group`` or fleet's ep axis) each rank holds E / ep
experts and both modes exchange the routes over the expert group
(dispatch.py's all-to-all for "grouped", the global capacity buffer's
reduce-scatter for "capacity"). ClipGradForMOEByGlobalNorm sums the
expert gradients' norm over the expert group. The routing telemetry is
not ported.
"""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import (ExpertMLP, MoELayer,  # noqa: F401
                        configure_moe_dispatch)
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
