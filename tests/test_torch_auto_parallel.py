"""The port's auto-parallel API (paddle_tpu_torch/distributed/auto_parallel/)
against the JAX package's, on the CPU: every case of
tests/test_auto_parallel.py, plus the Paddle-layout megatron split.

One world of 4 gloo ranks (tests/torch_auto_parallel_cases.py), started
once for the module, on the mesh [[0, 1], [2, 3]] named ["x", "y"]; the
JAX package runs the same calls on its 8-device CPU mesh (2 x 4) from the
same numpy inputs while the ranks run. Rank r sits at mesh coordinate
(r // 2, r % 2) and holds the shard at that coordinate.

Tolerances, and why:
- shard_tensor / reshard / unshard / shard_dataloader values: equal (a
  placement moves values, it computes nothing);
- the sharded matmul and its weight gradient: 1e-6 relative to the
  largest element (float32 sums in another order);
- the shard_layer / shard_optimizer losses (5 AdamW steps) and the
  DistModel train and predict outputs: 1e-5 relative (float32 through a
  few layers and optimizer steps);
- SGD, Momentum and AdamW with the global-norm clip, and TrainStep (SGD),
  over the sharded MLP against the JAX package's on its sharded MLP:
  losses STEP_RTOL relative, parameters STEP_ATOL relative to each
  tensor's largest (float32 through two packages; measured at most
  1.5e-7 and 1.9e-7); every parameter moves more than ten times that in
  the steps, so a skipped update fails.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn

import torch_dist_cases as cases

N = 4
PAIRS = [(0, None), (None, 0), (0, 1)]    # s -> r, r -> s, s -> s'
MATMUL_RTOL = 1e-6
LOSS_RTOL = 1e-5
LAYER_STEPS = 5
STATIC_CALLS = 11
OPT_STEPS = 3
CLIP_NORM = 0.01                  # below the MLP's gradient norm
STEP_RTOL = 1e-6
STEP_ATOL = 1e-6
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, max_position_embeddings=64,
             dtype="float32")


def _sd(model):
    return {k: np.asarray(v.numpy(), np.float32)
            for k, v in model.state_dict().items()}


def _jax_models():
    pt.seed(5)
    layer = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 8))
    pt.seed(7)
    static = jnn.Sequential(jnn.Linear(8, 8), jnn.ReLU(), jnn.Linear(8, 8))
    pt.seed(9)
    predict = jnn.Linear(4, 4)
    pt.seed(3)
    opt = jnn.Linear(8, 8)
    return layer, static, predict, opt


def _jax_refs(inp, layer, static, predict):
    mesh = jdist.ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["x", "y"])
    ref = {}
    a = pt.to_tensor(inp["a"])
    ref["placements"] = jdist.shard_tensor(
        a, mesh, [jdist.Shard(0), jdist.Shard(1)]).numpy()

    def plc(spec):
        return [jdist.Shard(spec) if spec is not None else jdist.Replicate()]
    ref["reshard"] = {}
    for src, dst in PAIRS:
        d = jdist.shard_tensor(pt.to_tensor(inp["b"]), mesh, plc(src))
        ref["reshard"][(src, dst)] = jdist.reshard(d, mesh, plc(dst)).numpy()

    x = jdist.shard_tensor(pt.to_tensor(inp["mx"]), mesh, [jdist.Shard(0)])
    w = jdist.shard_tensor(pt.to_tensor(inp["mw"]), mesh,
                           [jdist.Replicate(), jdist.Shard(1)])
    w.stop_gradient = False
    y = pt.matmul(x, w)
    (y ** 2).mean().backward()
    ref["matmul"] = {"y": y.numpy(), "grad": w.grad.numpy()}

    def shard_fn(name, sub, pm):
        for p in getattr(sub, "_parameters", {}).values():
            if p is not None and p.ndim == 2:
                jdist.shard_tensor(p, pm, [jdist.Replicate(), jdist.Shard(1)])

    jdist.shard_layer(layer, mesh, shard_fn)
    opt = jdist.shard_optimizer(pt.optimizer.AdamW(
        0.01, parameters=layer.parameters()))
    lx = jdist.shard_tensor(pt.to_tensor(inp["lx"]), mesh, [jdist.Shard(0)])
    ly = pt.to_tensor(inp["ly"])
    losses = []
    for _ in range(LAYER_STEPS):
        loss = jnn.functional.mse_loss(layer(lx), ly)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    ref["shard_layer"] = losses

    sopt = pt.optimizer.SGD(0.05, parameters=static.parameters())
    dm, _ = jdist.to_static(static, None, jnn.MSELoss(), sopt)
    sx, sy = pt.to_tensor(inp["sx"]), pt.to_tensor(inp["sy"])
    train = [float(dm(sx, sy)) for _ in range(STATIC_CALLS)]
    dm.eval()
    ref["to_static"] = {"train": train, "eval": float(dm(sx, sy))}

    dm, _ = jdist.to_static(predict)
    dm.eval()
    ref["predict"] = dm(pt.to_tensor(inp["px"])).numpy()
    ref["optimizers"], ref["train_step"] = _jax_optimizers(inp, mesh,
                                                           shard_fn)
    return ref


def _jax_layer(inp):
    pt.seed(5)
    layer = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 8))
    for k, v in _sd(layer).items():
        np.testing.assert_array_equal(v, inp["layer_sd"][k])
    return layer


def _jax_optimizers(inp, mesh, shard_fn):
    """The JAX package's SGD, Momentum and AdamW with the global-norm clip
    over its sharded MLP, each built before shard_layer, and its TrainStep
    (SGD) built before shard_layer: (losses, parameters after the steps,
    parameters before them)."""
    makers = {
        "sgd": lambda ps: pt.optimizer.SGD(0.1, parameters=ps,
                                           weight_decay=0.01),
        "momentum": lambda ps: pt.optimizer.Momentum(
            0.1, 0.9, parameters=ps, use_nesterov=True, weight_decay=0.01),
        "adamw_clip": lambda ps: pt.optimizer.AdamW(
            0.01, parameters=ps,
            grad_clip=jnn.ClipGradByGlobalNorm(CLIP_NORM))}
    ly = pt.to_tensor(inp["ly"])
    runs = {}
    for name, make in makers.items():
        layer = _jax_layer(inp)
        opt = make(layer.parameters())
        jdist.shard_layer(layer, mesh, shard_fn)
        lx = jdist.shard_tensor(pt.to_tensor(inp["lx"]), mesh,
                                [jdist.Shard(0)])
        losses = []
        for _ in range(OPT_STEPS):
            loss = jnn.functional.mse_loss(layer(lx), ly)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs[name] = (losses, _sd(layer), inp["layer_sd"])
    layer = _jax_layer(inp)
    step = pt.jit.TrainStep(layer, jnn.functional.mse_loss,
                            pt.optimizer.SGD(0.1,
                                             parameters=layer.parameters(),
                                             weight_decay=0.01))
    jdist.shard_layer(layer, mesh, shard_fn)
    lx = jdist.shard_tensor(pt.to_tensor(inp["lx"]), mesh, [jdist.Shard(0)])
    losses = [float(step((lx,), (ly,))) for _ in range(OPT_STEPS)]
    return runs, (losses, _sd(layer), inp["layer_sd"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(11)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    layer, static, predict, opt = _jax_models()
    inp = {"a": np.arange(64, dtype=np.float32).reshape(8, 8),
           "b": randn(8, 8), "pairs": PAIRS,
           "mx": randn(8, 16), "mw": randn(16, 32),
           "layer_sd": _sd(layer), "lx": randn(16, 8), "ly": randn(16, 8),
           "layer_steps": LAYER_STEPS,
           "static_sd": _sd(static), "sx": randn(8, 8), "sy": randn(8, 8),
           "static_calls": STATIC_CALLS,
           "loader": [(randn(8, 4), randn(8, 1)) for _ in range(3)],
           "predict_sd": _sd(predict), "px": randn(2, 4),
           "opt_sd": _sd(opt), "ox": randn(4, 8), "llama": LLAMA,
           "clip_norm": CLIP_NORM, "opt_steps": OPT_STEPS}
    handle = cases.start_world(N, "api", inp, tmp_path_factory.mktemp("ap"),
                               module="torch_auto_parallel_cases")
    ref = _jax_refs(inp, layer, static, predict)
    return inp, ref, cases.finish_world(handle)


def _block(a, coord, parts):
    """The block of ``a`` at mesh coordinate ``coord`` when dim i is split
    into parts[i] (None: whole)."""
    idx = []
    for dim, (c, k) in enumerate(zip(coord, parts)):
        if k is None:
            idx.append(slice(None))
        else:
            step = a.shape[dim] // k
            idx.append(slice(c * step, (c + 1) * step))
    return a[tuple(idx)]


def test_shard_tensor_placements(world):
    inp, ref, res = world
    np.testing.assert_array_equal(ref["placements"], inp["a"])
    for r in res:
        got = r["placements"]
        assert got["is_shard0"] and got["mesh_is"]
        np.testing.assert_array_equal(got["full"], ref["placements"])
        np.testing.assert_array_equal(
            got["local"], _block(inp["a"], r["coord"], (2, 2)))


@pytest.mark.parametrize("src,dst", PAIRS)
def test_reshard_pairs(world, src, dst):
    inp, ref, res = world
    want = ref["reshard"][(src, dst)]
    for r in res:
        got = r["reshard"][(src, dst)]
        np.testing.assert_array_equal(got["full"], want)
        # the mesh's first axis splits the tensor dim dst names
        parts = [None, None]
        if dst is not None:
            parts[dst] = 2
        coord = [r["coord"][0] if p else 0 for p in parts]
        np.testing.assert_array_equal(got["local"],
                                      _block(want, coord, parts))


def test_semi_auto_matmul_propagates(world):
    inp, ref, res = world
    want = ref["matmul"]
    for r in res:
        got = r["matmul"]
        for k in ("y", "grad"):
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=MATMUL_RTOL * np.abs(want[k]).max())
        # the weight's gradient is its shard (columns split over "y")
        assert got["grad_local_shape"] == got["w_local_shape"] == (16, 16)


def test_shard_layer_and_optimizer(world):
    inp, ref, res = world
    for r in res:
        got = r["shard_layer"]
        np.testing.assert_allclose(got["losses"], ref["shard_layer"],
                                   rtol=LOSS_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        # adam moments follow their parameter's placements
        assert got["n_accs"] == 8 and got["accs_follow"]
        # Paddle's Shard(1) of a [in, out] weight is torch's Shard(0) of
        # the [out, in] weight the port stores
        assert got["weight_placements"] == [
            "[Replicate(), Shard(dim=1)]",
            "(Replicate(), Shard(dim=0))"]


def _steps_match(losses, params, want):
    """``losses`` and ``params`` (a port run) against ``want`` (the JAX
    package's (losses, parameters after, parameters before)). A step that
    skipped the update would fail: every JAX parameter moved further
    than STEP_ATOL allows from where it began."""
    w_losses, w_params, w_before = want
    np.testing.assert_allclose(losses, w_losses, rtol=STEP_RTOL)
    assert set(params) == set(w_params)
    for k, w in w_params.items():
        tol = STEP_ATOL * np.abs(w).max()
        np.testing.assert_allclose(params[k], w, rtol=0, atol=tol,
                                   err_msg=k)
        assert np.abs(w - w_before[k]).max() > 10 * tol, k
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw_clip"])
def test_optimizers_and_clip_over_dtensors(world, name):
    """Each rank steps its shards as the JAX package steps its sharded MLP
    (SGD and Momentum with L2 decay, AdamW with ClipGradByGlobalNorm, each
    built before shard_layer); the clip's norm is the whole gradients'
    (every step clips, so a rank's local norm would scale differently).
    The port's dense run steps the same way."""
    inp, ref, res = world
    for r in res:
        (dl, dp), (sl, sp) = r["optimizers"][name]
        _steps_match(sl, sp, ref["optimizers"][name])
        _steps_match(dl, dp, ref["optimizers"][name])


def test_train_step_built_before_shard_layer(world):
    """TrainStep holds the DTensor parameters shard_layer swapped in, and
    its steps are the JAX package's TrainStep's on its sharded MLP."""
    inp, ref, res = world
    for r in res:
        got = r["train_step"]
        assert got["holds"] == [True] * 4
        _steps_match(got["losses"], got["params"], ref["train_step"])


def test_to_static_dist_model(world):
    inp, ref, res = world
    for r in res:
        got = r["to_static"]
        np.testing.assert_allclose(got["train"], ref["to_static"]["train"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["eval"], ref["to_static"]["eval"],
                                   rtol=LOSS_RTOL)
        assert got["train"][-1] < got["train"][0]


def test_shard_dataloader(world):
    inp, ref, res = world
    x0, y0 = inp["loader"][0]
    for r in res:
        got = r["dataloader"]
        assert got["n"] == 3 and got["is_shard0"]
        rows = slice(4 * r["coord"][0], 4 * r["coord"][0] + 4)
        np.testing.assert_array_equal(got["local"], x0[rows])
        np.testing.assert_array_equal(got["y_local"], y0[rows])


def test_partial_placement_rejected(world):
    inp, ref, res = world
    with pytest.raises(NotImplementedError):
        jdist.shard_tensor(pt.randn([4, 4]), jdist.ProcessMesh(
            np.arange(8).reshape(2, 4), dim_names=["x", "y"]),
            [jdist.Partial()])
    for r in res:
        assert r["partial"] == ["NotImplementedError", "NotImplementedError"]


def test_dist_model_predict_keeps_all_args(world):
    inp, ref, res = world
    for r in res:
        np.testing.assert_allclose(r["predict"]["dm"], r["predict"]["direct"])
        np.testing.assert_allclose(r["predict"]["dm"], ref["predict"],
                                   rtol=LOSS_RTOL, atol=1e-6)


def test_shard_optimizer_applies_shard_fn(world):
    inp, ref, res = world
    for r in res:
        got = r["shard_opt_fn"]
        assert got["calls"] == ["moment1", "moment2"]
        # the reference's ShardingStage markers have no __call__: the port
        # refuses them where they are passed
        assert got["stage_markers"] == ["NotImplementedError"] * 3


def test_unshard_dtensor(world):
    inp, ref, res = world
    for r in res:
        got = r["unshard"]
        assert got["mesh"] is None and got["is_dense"]
        np.testing.assert_array_equal(got["values"], inp["a"])


def test_megatron_shard_fn_splits_in_paddle_layout(world):
    """The reference's megatron shard_fn (column Shard(1), row Shard(0) in
    Paddle's [in, out] layout) splits the output rows of q_proj and the
    input columns of o_proj as the port stores them ([out, in])."""
    inp, ref, res = world
    heads_d = LLAMA["hidden_size"]          # heads * head_dim
    for r in res:
        got = r["layout"]
        assert got["q_local"] == (heads_d // 2, LLAMA["hidden_size"])
        assert got["o_local"] == (LLAMA["hidden_size"], heads_d // 2)
        assert got["q_paddle"] == "[Replicate(), Shard(dim=1)]"
        assert got["o_paddle"] == "[Replicate(), Shard(dim=0)]"
        assert got["q_torch"] == "(Replicate(), Shard(dim=0))"


def test_rerouted_all_gather_gathers_the_mesh_group(world):
    """The c10d body a gloo rank on a card routes DTensor's functional
    all-gathers to: rank r's rows come out in group-rank order over its
    mesh column (ranks r % 2 and r % 2 + 2)."""
    inp, ref, res = world
    for r, got in enumerate(res):
        col = r % 2
        np.testing.assert_array_equal(
            got["c10d_gather"], np.repeat([[col], [col + 2]], 3, axis=1))


def test_mesh_larger_than_the_world_raises(world):
    """The reference wraps process ids modulo its device count; the port's
    process ids are ranks, and a mesh naming rank 4..7 of 4 raises."""
    inp, ref, res = world
    assert all(r["too_big"] == "ValueError" for r in res)


def test_all_gather_reroute_ends_with_the_world():
    """The reroute of torch's functional all-gathers (a gloo rank on a
    card) is undone by destroy_process_group, so a world joined later, on
    NCCL or on the host, gathers through torch's own kernels."""
    import torch
    from paddle_tpu_torch.distributed import collective

    def routed():
        return [torch._C._dispatch_has_kernel_for_dispatch_key(
            f"_c10d_functional::{op}", "CUDA")
            for op in ("all_gather_into_tensor",
                       "all_gather_into_tensor_coalesced")]
    before = routed()
    collective.reroute_gloo_cuda_all_gather()
    try:
        assert routed() == [True, True]
    finally:
        collective.destroy_process_group()
    assert routed() == before and not collective._REROUTED


def test_mesh_on_a_gloo_world_joined_elsewhere_raises():
    """A gloo world the port did not join says nothing of where its
    ranks' tensors lie: ProcessMesh asks for init_parallel_env(device=)
    instead of building a host mesh for tensors that may be on a card."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import ProcessMesh, collective
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            ProcessMesh([[0]], dim_names=["dp", "mp"]).device_mesh()
    finally:
        collective.destroy_process_group()


def test_process_mesh_api():
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.auto_parallel import get_current_mesh
    m = ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    j = jdist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    assert m.shape == j.shape == [2, 2] and m.ndim == j.ndim == 2
    assert m.process_ids == j.process_ids == [0, 1, 2, 3]
    assert m.get_dim_size("mp") == j.get_dim_size("mp") == 2
    for pid in range(4):
        assert m.get_rank_by_dim_and_process_id("mp", pid) == \
            j.get_rank_by_dim_and_process_id("mp", pid)
    assert m == ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    assert hash(m) == hash(ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"]))
    assert m != ProcessMesh([[0, 1], [2, 3]], ["x", "y"])
    with m:
        assert get_current_mesh() is m
    assert get_current_mesh() is None
