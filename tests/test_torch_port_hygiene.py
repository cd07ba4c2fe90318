"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU silently, and the
options it has not ported raise instead of being ignored."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import seed
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.decode import CachedDecoder
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny)
from paddle_tpu_torch.models.paged_decode import PagedDecoder
from paddle_tpu_torch.nn.functional.loss import cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


# the rank side of the distributed tests: spawned ranks unpickle their
# functions from these, so they must load neither
RANK_HELPERS = [ROOT / "tests" / "torch_dist_cases.py",
                ROOT / "tests" / "torch_zero_cases.py",
                ROOT / "tests" / "torch_auto_parallel_cases.py",
                ROOT / "tests" / "torch_cm_cases.py"]


def _port_sources():
    files = sorted(PORT.rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files + RANK_HELPERS


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 10
    assert any("distributed" in f.parts for f in files)
    bad = []
    for f in files:
        roots = set(_imported_roots(ast.parse(f.read_text(), str(f))))
        bad += [f"{f.relative_to(ROOT)}: {r}" for r in roots
                if r in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "distributed/passes/pipeline_scheduler.py",
    "distributed/fleet/meta_parallel/pipeline_spmd.py",
    "distributed/fleet/meta_parallel/pp_layers.py",
    "models/_stacked_pipe.py", "models/llama_pipe.py",
    "models/gpt_pipe.py"])
def test_pipeline_modules_are_scanned_and_stand_alone(module):
    """The pipeline's modules are among the scanned sources, and import
    neither JAX nor the JAX package (the scheduler is the port's own
    copy)."""
    f = PORT / module
    assert f in _port_sources()
    roots = set(_imported_roots(ast.parse(f.read_text(), str(f))))
    assert not roots & set(FORBIDDEN), roots


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, paddle_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_dist_cases\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")


def test_entry_points_need_a_card_or_an_explicit_cpu(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(llama_tiny())
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CachedDecoder(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedDecoder(model, max_len=64, block_size=16)
    dec = PagedDecoder(model, max_len=64, block_size=16, device="cpu")
    assert dec.device.type == "cpu" and not dec.use_ragged_kernel


def test_seed_needs_a_card_or_an_explicit_cpu(no_card):
    """The exported generator factory follows the entry points' rule: no
    device means the card."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seed(0)
    gen = seed(3, device="cpu")
    assert gen.device.type == "cpu" and gen.initial_seed() == 3


@pytest.mark.parametrize("opt", [
    {"kv_offload": True, "prefix_cache": True}, {"hbm_budget_gib": 1.0},
    {"hbm_budget_gib": 1.0, "prefix_cache": True}, {"kv_offload": True},
    {"headroom_guard": object(), "prefix_cache": True},
    {"headroom_guard": object()},
    {"kv_offload": True, "prefix_cache": "radix", "prefill_chunk": 32},
    {"block_size": "auto"}])
def test_unported_decoder_options_raise(opt):
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    kw = dict(max_len=64, block_size=16, device="cpu")
    kw.update(opt)
    with pytest.raises(NotImplementedError):
        PagedDecoder(model, **kw)


@pytest.mark.parametrize("opt", [
    {"prefix_cache": True}, {"prefix_cache": "radix"},
    {"prefix_cache": True, "prefix_cache_blocks": 4},
    {"prefix_cache": True, "prefill_chunk": 32}, {"prefill_chunk": 16}])
def test_ported_decoder_options_construct(opt):
    """The prefix cache's options build an engine that serves."""
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    dec = PagedDecoder(model, max_len=64, block_size=16, device="cpu", **opt)
    assert (dec.prefix_cache is not None) == bool(opt.get("prefix_cache"))
    out = dec.serve([("a", list(range(1, 20)))], max_new_tokens=3)
    assert len(out["a"]) == 3
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedDecoder(model, max_len=64, block_size=16, device="cpu",
                     prefill_chunk=8)


@pytest.mark.parametrize("opt", [
    {"spec_decode": 2}, {"feed": list}, {"feed_active": bool},
    {"evict_after_deferrals": 1}, {"max_chunk_retries": 0},
    {"max_deferrals": 1}])
def test_unported_serve_options_raise(opt):
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    dec = PagedDecoder(model, max_len=64, block_size=16, device="cpu")
    with pytest.raises(NotImplementedError):
        dec.serve([("a", [1, 2, 3])], max_new_tokens=2, **opt)


@pytest.mark.parametrize("site", ["paged_kv_alloc", "prefill_chunk",
                                  "decode_chunk", "headroom_pressure"])
def test_unhooked_fault_sites_raise(site):
    """A fault plan that names a site the port's serve does not hook would
    inject nothing: serve refuses it."""
    from paddle_tpu_torch.resilience import faults
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    dec = PagedDecoder(model, max_len=64, block_size=16, device="cpu")
    faults.install_plan({"sites": {site: {"p": 1.0}}})
    try:
        with pytest.raises(NotImplementedError, match=site):
            dec.serve([("a", [1, 2, 3])], max_new_tokens=2)
    finally:
        faults.clear()


@pytest.mark.parametrize("field", ["tensor_parallel", "sequence_parallel",
                                   "pipeline_parallel", "context_parallel",
                                   "recompute", "num_experts"])
def test_unported_model_options_raise(field):
    kw = {field: 4 if field == "num_experts" else True}
    if field == "recompute":
        # whole-layer recompute (policy None) is ported; a selective
        # policy is not
        kw["recompute_policy"] = "dots"
    if field == "tensor_parallel":
        # tensor and sequence parallelism are ported; context (ring)
        # parallelism with them is not
        kw["context_parallel"] = True
    if field == "sequence_parallel":
        # sequence parallelism is ported under tensor parallelism; under
        # the pipeline it is not
        kw["pipeline_parallel"] = True
    if field == "pipeline_parallel":
        # pipeline parallelism is ported; its MoE stack is not
        kw["num_experts"] = 4
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(llama_tiny(**kw), device="cpu")


def test_tensor_parallel_at_one_rank_is_the_dense_model():
    """Without fleet (one rank) tensor_parallel=True builds the dense
    model's weights and computes its logits and loss bit for bit."""
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    tp = LlamaForCausalLM(llama_tiny(tensor_parallel=True), device="cpu")
    dense = LlamaForCausalLM(llama_tiny(), device="cpu")
    for (n, a), (m, b) in zip(tp.named_parameters(),
                              dense.named_parameters()):
        assert n == m and torch.equal(a, b), n
    assert torch.equal(tp(ids), dense(ids))
    assert torch.equal(
        LlamaPretrainingCriterion(llama_tiny(tensor_parallel=True))(
            tp(ids), ids),
        LlamaPretrainingCriterion()(dense(ids), ids))


def test_training_needs_a_card_or_cpu_tensors(no_card):
    """The optimizer and the train step run where their tensors lie: CPU
    tensors take the plain path, anything else needs a card."""
    model = LlamaForCausalLM(llama_tiny(), device="cpu").to("meta")
    with pytest.raises(RuntimeError, match="CUDA card"):
        AdamW(parameters=model.parameters())
    with pytest.raises(RuntimeError, match="CUDA card"):
        TrainStep(model, lambda lo, la: lo.sum(), object())
    cpu = LlamaForCausalLM(llama_tiny(), device="cpu")
    step = TrainStep(cpu, LlamaPretrainingCriterion(),
                     AdamW(parameters=cpu.parameters()))
    ids = [[1, 2, 3, 4]]
    loss = step((ids,), (ids,))            # lists go to the model's device
    assert loss.device.type == "cpu" and torch.isfinite(loss)


def test_unported_training_options_raise():
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    with pytest.raises(NotImplementedError):
        AdamW(parameters=model.parameters(), grad_clip=object())
    with pytest.raises(NotImplementedError):
        AdamW(learning_rate=lambda: 1e-3, parameters=model.parameters())
    with pytest.raises(NotImplementedError):      # an L2Decay-style object
        Adam(parameters=model.parameters(), weight_decay=object())
    with pytest.raises(NotImplementedError):
        Adam(parameters=[{"params": model.parameters(),
                          "weight_decay": object()}])
    opt = AdamW(parameters=model.parameters())
    from paddle_tpu_torch.distributed.fleet import GradBucketScheduler
    with pytest.raises(NotImplementedError):
        TrainStep(model, lambda lo, la: lo.sum(), opt,
                  grad_sync=GradBucketScheduler(
                      list(model.named_parameters()), bucket_mb="auto"))
    with pytest.raises(NotImplementedError):
        TrainStep(model, lambda lo, la: lo.sum(), opt, plan=object())
    logits = torch.zeros(2, 5)
    with pytest.raises(NotImplementedError):
        cross_entropy(logits, torch.softmax(logits, -1), soft_label=True)
    # pipeline parallelism is ported and needs fleet's pp topology
    with pytest.raises(ValueError, match="pp topology"):
        LlamaForCausalLM(llama_tiny(tensor_parallel=True,
                                    pipeline_parallel=True), device="cpu")


def test_config_mirrors_the_jax_widths():
    from paddle_tpu_torch.models.llama import llama_2_7b
    cfg = llama_2_7b(dtype="bfloat16")
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.head_dim) == \
        (32000, 4096, 11008, 32, 32, 32, 128)
    assert isinstance(cfg, LlamaConfig)


def test_moe_entry_points_need_a_card_or_an_explicit_cpu(no_card):
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ExpertMLP, GShardGate, MoELayer)
    from paddle_tpu_torch.models.gpt_moe import MoEGPT, gpt_moe_tiny
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention
    for build in (lambda **kw: MoELayer(d_model=16, num_expert=4, **kw),
                  lambda **kw: GShardGate(16, 4, **kw),
                  lambda **kw: ExpertMLP(4, 16, 32, **kw),
                  lambda **kw: MultiHeadAttention(16, 2, **kw),
                  lambda **kw: MoEGPT(gpt_moe_tiny(vocab_size=32), **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        build(device="cpu")


@pytest.mark.parametrize("kw", [{"dropout": 0.1}, {"need_weights": True},
                                {"weight_attr": object()},
                                {"bias_attr": False}])
def test_unported_attention_options_raise(kw):
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention
    with pytest.raises(NotImplementedError):
        MultiHeadAttention(16, 2, device="cpu", **kw)


def test_unported_attention_call_options_raise():
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention
    mha = MultiHeadAttention(16, 2, device="cpu")
    x = torch.zeros(1, 4, 16)
    with pytest.raises(NotImplementedError):
        mha(x, attn_mask=torch.ones(4, 4, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        mha(x, cache=object())
    with pytest.raises(NotImplementedError):
        mha(x, torch.zeros(1, 6, 16), torch.zeros(1, 6, 16))
    assert mha(x).shape == (1, 4, 16)


def test_grouped_kernels_refuse_other_devices():
    """The kernel wrappers take the plain version only for CPU tensors;
    any other device raises instead of falling back."""
    from paddle_tpu_torch.kernels.grouped_matmul import (
        grouped_matmul_dw, grouped_matmul_fwd, grouped_metadata)
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_grouped_matmul, quantize_weight_blockwise)
    md = grouped_metadata(torch.tensor([0, 1, 1], dtype=torch.int32), 2, 8)
    md = {k: v.to("meta") for k, v in md.items()}
    x = torch.zeros(md["row_src"].shape[0], 8, device="meta")
    w = torch.zeros(2, 8, 4, device="meta")
    with pytest.raises(RuntimeError, match="no grouped_matmul kernel"):
        grouped_matmul_fwd(x, w, None, md["offsets"], md["counts"], 8)
    with pytest.raises(RuntimeError, match="no grouped_matmul kernel"):
        grouped_matmul_dw(x, x, md["offsets"], md["counts"], 8, 2)
    codes, scales = quantize_weight_blockwise(torch.zeros(2, 4, 8))
    with pytest.raises(RuntimeError, match="no quant_grouped_matmul kernel"):
        quant_grouped_matmul(x, codes.to("meta"), scales.to("meta"),
                             group_offsets=md["offsets"],
                             group_counts=md["counts"], bm=8)


@pytest.mark.parametrize("call", [
    "fused_dropout_add", "fused_bias_dropout_residual_layer_norm",
    "rms_norm_axis", "layer_norm_axis"])
def test_unported_incubate_options_raise(call):
    """Dropout that would draw random numbers (training with p > 0) and a
    begin_norm_axis other than the last axis raise instead of being
    ignored."""
    import paddle_tpu_torch.incubate.nn.functional as F
    x = torch.zeros(2, 4, 128)
    w = torch.ones(128)
    with pytest.raises(NotImplementedError):
        if call == "fused_dropout_add":
            F.fused_dropout_add(x, x, p=0.1, training=True)
        elif call == "fused_bias_dropout_residual_layer_norm":
            F.fused_bias_dropout_residual_layer_norm(x, x, dropout_rate=0.1)
        elif call == "rms_norm_axis":
            F.fused_rms_norm(x, w, begin_norm_axis=1)
        else:
            F.fused_layer_norm(x, w, None, begin_norm_axis=0)


def test_row_wise_entry_points_run_where_their_inputs_lie():
    """The incubate entry points take their inputs' device: CPU tensors run
    the plain versions, tensors elsewhere reach a kernel wrapper, which
    raises for a device with no kernel."""
    import paddle_tpu_torch.incubate as inc
    import paddle_tpu_torch.incubate.nn.functional as F
    x = torch.zeros(2, 128, 2, 128)
    assert F.fused_rms_norm(x, torch.ones(128)).device.type == "cpu"
    assert F.fused_rotary_position_embedding(
        x, use_neox_rotary_style=False)[0].device.type == "cpu"
    assert inc.softmax_mask_fuse_upper_triangle(
        torch.zeros(1, 128, 128)).device.type == "cpu"
    meta = x.to("meta")
    with pytest.raises(RuntimeError, match="no RMSNorm kernel"):
        F.fused_rms_norm(meta, torch.ones(128, device="meta"))
    with pytest.raises(RuntimeError, match="no RoPE kernel"):
        F.fused_rotary_position_embedding(
            meta, sin=torch.zeros(128, 128, device="meta"),
            cos=torch.zeros(128, 128, device="meta"),
            use_neox_rotary_style=False)
    with pytest.raises(RuntimeError, match="no causal softmax kernel"):
        inc.softmax_mask_fuse_upper_triangle(
            torch.zeros(1, 128, 128, device="meta"))


def test_vision_entry_points_need_a_card_or_an_explicit_cpu(no_card):
    """The ResNet slice's constructors follow the entry points' rule."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.vision.models import BasicBlock, BottleneckBlock
    for build in (lambda **kw: ptt.vision.models.resnet18(num_classes=10,
                                                          **kw),
                  lambda **kw: ptt.vision.models.resnet50(num_classes=0,
                                                          **kw),
                  lambda **kw: BasicBlock(8, 8, **kw),
                  lambda **kw: BottleneckBlock(16, 4, **kw),
                  lambda **kw: ptt.nn.Conv2D(3, 4, 3, **kw),
                  lambda **kw: ptt.nn.Conv1DTranspose(3, 4, 3, **kw),
                  lambda **kw: ptt.nn.BatchNorm2D(4, **kw),
                  lambda **kw: ptt.nn.SyncBatchNorm(4, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert all(p.device.type == "cpu"
                   for p in build(device="cpu").parameters())


@pytest.mark.parametrize("name", ["ReLU6", "Sigmoid", "Tanh", "LeakyReLU",
                                  "Softmax", "Silu", "PReLU", "GLU"])
def test_unported_activation_layers_raise(name):
    import paddle_tpu_torch as ptt
    with pytest.raises(NotImplementedError, match=name):
        getattr(ptt.nn, name)()
