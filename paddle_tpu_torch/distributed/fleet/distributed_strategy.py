"""DistributedStrategy (counterpart of
paddle_tpu/distributed/fleet/distributed_strategy.py).

The reference's fields and defaults, and its ``validate()``. The knobs of
slices not ported yet raise NotImplementedError, naming themselves, when
``validate()`` (fleet.init) finds them set: ``sep_degree`` above 1, and
these combinations: ``sharding_degree`` above 1 with ``mp_degree`` or
``pp_degree`` above 1 or with the gradient sync's knobs, ``ep_degree``
above 1 with ``mp_degree`` or ``pp_degree`` above 1. Data, tensor,
pipeline and sharding parallelism (``dp_degree``, ``mp_degree``,
``pp_degree`` with ``pp_configs``, ``sharding_degree``), expert
parallelism (``ep_degree``) with its ``dispatch_compress`` wire codec,
the gradient sync's ``grad_compress`` and ``grad_bucket_mb``, the
collective matmul's ``mp_overlap``, ``mp_activation_compress`` and
``mp_overlap_chunks``, the quantized products' ``matmul_quant``, and
``pipeline_save_mode`` (validated as the reference does; the port's
pipeline keeps one storage whatever its value) are ported.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _SubConfig(dict):
    def __getattr__(self, k):
        return self.get(k)

    def __setattr__(self, k, v):
        self[k] = v


_LATER_DEGREES = ("sep_degree",)


class DistributedStrategy:
    def __init__(self):
        object.__setattr__(self, "_explicit_fields", None)
        self._hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "ep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
            "mp_configs": _SubConfig(),
            "pp_configs": _SubConfig(
                micro_batch_size=1, accumulate_steps=1,
                delay_scale_loss=False, enable_timer=False,
                sharding_comm_overlap=False, schedule_mode="1F1B"),
            "sharding_configs": _SubConfig(),
        }
        self.amp = False
        self.amp_configs = _SubConfig(init_loss_scaling=32768.0,
                                      use_pure_fp16=False, use_bf16=False)
        self.recompute = False
        self.recompute_configs = _SubConfig(checkpoints=[])
        self.gradient_merge = False
        self.gradient_merge_configs = _SubConfig(k_steps=1, avg=True)
        self.sharding = False
        self.sharding_configs = _SubConfig()
        self.pipeline = False
        self.pipeline_configs = _SubConfig(accumulate_steps=1,
                                           micro_batch_size=1)
        self.tensor_parallel = False
        self.tensor_parallel_configs = _SubConfig(tensor_parallel_degree=1)
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = True
        self.gradient_scale_configs = _SubConfig(scale_strategy="avg")
        # the gradient sync (fleet/grad_buckets.py): grad_compress = None |
        # "int8" | "bf16" selects the compressed all-reduce bodies,
        # grad_bucket_mb the bucket size in MiB
        self.grad_compress = None
        self.grad_bucket_mb = None
        # the expert-parallel dispatch's wire codec: None | "int8" | "bf16"
        self.dispatch_compress = None
        # the collective matmul (fleet/meta_parallel/collective_matmul.py):
        # the permute rings, their wire codec None | "int8" | "bf16" and
        # the chunks a hop
        self.mp_overlap = False
        self.mp_activation_compress = None
        self.mp_overlap_chunks = "auto"
        # the mp layers' quantized products: None | "int8" | "fp8"
        self.matmul_quant = None
        # the pipeline's backward-save mode: None (the model's default),
        # "scan", "unroll" or "buffer"
        self.pipeline_save_mode = None
        object.__setattr__(self, "_explicit_fields", set())

    def __setattr__(self, k, v):
        exp = getattr(self, "_explicit_fields", None)
        if isinstance(exp, set) and not k.startswith("_"):
            exp.add(k)
        super().__setattr__(k, v)

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs):
        exp = getattr(self, "_explicit_fields", None)
        for k, v in configs.items():
            if k.endswith("_configs") and isinstance(v, dict):
                self._hybrid_configs[k].update(v)
            else:
                self._hybrid_configs[k] = v
                if isinstance(exp, set):
                    exp.add(k)

    def validate(self):
        """Raise NotImplementedError for a knob of a later slice that is
        set, then the reference's ValueError naming every incoherent knob
        combination; returns self."""
        hc = self._hybrid_configs
        for deg in _LATER_DEGREES:
            if int(hc.get(deg, 1)) > 1:
                raise NotImplementedError(
                    f"hybrid_configs {deg}={hc[deg]} is not ported to the "
                    f"PyTorch package yet (data, tensor, pipeline, sharding "
                    f"and expert parallelism are)")
        dp = int(hc.get("dp_degree", 1))
        mp = int(hc.get("mp_degree", 1))
        pp = int(hc.get("pp_degree", 1))
        ep = int(hc.get("ep_degree", 1))
        sharding = int(hc.get("sharding_degree", 1))
        for deg, val in (("sharding_degree", sharding), ("ep_degree", ep)):
            if val > 1 and (mp > 1 or pp > 1):
                raise NotImplementedError(
                    f"hybrid_configs {deg}={val} with mp_degree={mp} and "
                    f"pp_degree={pp}: {deg.split('_')[0]} parallelism "
                    f"combined with tensor or pipeline parallelism is not "
                    f"ported to the PyTorch package yet")
        if sharding > 1:
            for knob in ("grad_compress", "grad_bucket_mb"):
                if getattr(self, knob, None):
                    raise NotImplementedError(
                        f"DistributedStrategy.{knob} with sharding_degree="
                        f"{sharding}: the gradient sync's codecs and buckets "
                        f"on the sharding axis are not ported to the "
                        f"PyTorch package yet")
        errors = []
        codecs = (None, "int8", "bf16")
        if getattr(self, "mp_overlap", False) and mp <= 1:
            errors.append(
                "mp_overlap=True with mp_degree==1: there are no mp "
                "collectives to decompose into permute rings")
        if getattr(self, "mp_activation_compress", None) and \
                not getattr(self, "mp_overlap", False):
            errors.append(
                "mp_activation_compress set without mp_overlap: the "
                "wire codec rides the collective-matmul rings only")
        if getattr(self, "grad_compress", None) and dp * sharding == 1:
            errors.append(
                "grad_compress set with dp_degree*sharding_degree==1: "
                "there is no gradient wire to compress")
        if getattr(self, "grad_bucket_mb", None) and dp * sharding == 1:
            errors.append(
                "grad_bucket_mb set with dp_degree*sharding_degree==1: "
                "there are no grad-sync collectives to bucket")
        if getattr(self, "pipeline_save_mode", None) and pp <= 1:
            errors.append(
                f"pipeline_save_mode="
                f"{getattr(self, 'pipeline_save_mode')!r} with "
                f"pp_degree==1: there is no pipeline backward to "
                f"restructure")
        if getattr(self, "dispatch_compress", None) and ep <= 1:
            errors.append(
                "dispatch_compress set with ep_degree==1: there is no "
                "expert-parallel all_to_all wire")
        for knob in ("grad_compress", "mp_activation_compress",
                     "dispatch_compress"):
            v = getattr(self, knob, None)
            if v not in codecs:
                errors.append(f"{knob}={v!r} not in {codecs}")
        mq = getattr(self, "matmul_quant", None)
        if mq not in (None, "int8", "fp8"):
            errors.append(
                f"matmul_quant={mq!r} not in (None, 'int8', 'fp8')")
        sm = getattr(self, "pipeline_save_mode", None)
        if sm not in (None, "scan", "unroll", "buffer"):
            errors.append(
                f"pipeline_save_mode={sm!r} not in "
                f"(None, 'scan', 'unroll', 'buffer')")
        if errors:
            raise ValueError(
                "incoherent DistributedStrategy knobs:\n  - "
                + "\n  - ".join(errors))
        return self

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self._hybrid_configs})"
