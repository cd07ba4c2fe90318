"""The port's pipeline layers (fleet/meta_parallel/pp_layers.py) and
fleet's PipelineParallel against the JAX package, on the CPU.

SegmentLayers cuts a descriptor list where the reference cuts it
(uniformly, by parameter count, by a layer-name pattern). A PipelineLayer
of a shared embedding (its tied head a SharedLayerDesc with a
forward_func), three Linears and the head, under fleet's PipelineParallel
with accumulate_steps 2, trains 3 SGD steps by ``train_batch`` in a world
of 2 ranks (pp 2, gloo, spawned by tests/torch_dist_cases.py), each rank
building only its stage; the JAX PipelineLayer (one program) under the
JAX fleet's PipelineParallel gives the reference losses, from the same
weights. fleet.distributed_model over Llama with pipeline_parallel=True
returns PipelineParallel and sets the stack's microbatch count from
accumulate_steps, leaving the config alone (tests/test_pipeline_llama.py:
275-302). Tolerance: float32 losses summed in other orders, 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jpl

from paddle_tpu_torch.distributed.fleet.meta_parallel import pp_layers as tpl

import torch_dist_cases as cases

V, H, MID, B, S = 32, 16, 3, 4, 8
LR, STEPS = 0.5, 3


def _descs(mod, nn, sizes):
    return [mod.LayerDesc(nn.Linear, i, o) for i, o in sizes]


SIZES = [(8, 8), (8, 64), (64, 64), (64, 8), (8, 8), (8, 128), (128, 8)]


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("method", ["uniform", "parameters", "layer:Linear"])
def test_segment_boundaries_match_the_reference(parts, method):
    ours, _ = tpl.SegmentLayers(_descs(tpl, torch.nn, SIZES), parts,
                                method).do_segment()
    ref = jpl.SegmentLayers(_descs(jpl, pt.nn, SIZES), parts,
                            method).do_segment()[0]
    assert ours == ref


def test_layer_desc_needs_a_module_class():
    with pytest.raises(TypeError):
        tpl.LayerDesc(lambda: None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, V, (B, S))
    labels = rng.integers(0, V, (B, S))
    saved = mesh_mod._global_mesh[0]
    try:
        st = jdist.fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 4, "mp_degree": 1, "pp_degree": 2,
                             "pp_configs": {"accumulate_steps": 2}}
        jdist.fleet.init(is_collective=True, strategy=st)
        pt.seed(5)
        F = pt.nn.functional

        def head(layer, x):
            return pt.matmul(x, layer.weight, transpose_y=True)

        def loss_fn(logits, lab):
            return F.cross_entropy(logits.reshape([-1, V]),
                                   lab.reshape([-1]))

        descs = [jpl.SharedLayerDesc("emb", pt.nn.Embedding, None,
                                     "weight", V, H)]
        descs += [jpl.LayerDesc(pt.nn.Linear, H, H) for _ in range(MID)]
        descs += [jpl.SharedLayerDesc("emb", pt.nn.Embedding, head,
                                      "weight", V, H)]
        pl = jpl.PipelineLayer(descs, num_stages=2, loss_fn=loss_fn)
        weights = {}
        for i, layer in enumerate(pl.run_function):
            for name, p in layer.named_parameters():
                a = np.asarray(p.numpy(), np.float32)
                weights[f"{i}.{name}"] = a.T if a.ndim == 2 and \
                    isinstance(layer, pt.nn.Linear) else a
        payload = {"vocab": V, "hidden": H, "mid": MID, "weights": weights,
                   "accumulate_steps": 2, "lr": LR, "steps": STEPS,
                   "ids": ids, "labels": labels,
                   "llama_cfg": dict(vocab_size=64, hidden_size=32,
                                     intermediate_size=64,
                                     num_hidden_layers=2,
                                     num_attention_heads=2,
                                     max_position_embeddings=16,
                                     use_flash_attention=False),
                   "llama_ids": rng.integers(0, 64, (4, 16))}
        handle = cases.start_world(2, "pp_layers", payload,
                                   tmp_path_factory.mktemp("pp_layers"))
        model = jdist.fleet.distributed_model(pl)
        opt = pt.optimizer.SGD(learning_rate=LR,
                               parameters=model.parameters())
        data = (pt.to_tensor(ids, dtype="int64"),
                pt.to_tensor(labels, dtype="int64"))
        losses = [float(model.train_batch(data, opt)) for _ in range(STEPS)]
        ref = {"losses": losses,
               "emb": np.asarray(pl.run_function[0].weight.numpy()),
               "eval": float(model.eval_batch(data))}
        return ref, cases.finish_world(handle)
    finally:
        mesh_mod._global_mesh[0] = saved


def test_train_batch_matches_the_reference(run):
    ref, world = run
    for r in world:
        assert r["wrapper"] == "PipelineParallel"
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["eval"], ref["eval"], rtol=1e-5,
                                   atol=1e-6)


def test_shared_embedding_gets_both_gradients(run):
    """The embedding (stage 0) and the tied head (stage 1) are one weight
    in the reference; the two ranks' copies take the summed step."""
    ref, world = run
    np.testing.assert_array_equal(world[0]["emb"], world[1]["emb"])
    np.testing.assert_allclose(world[0]["emb"], ref["emb"], rtol=1e-5,
                               atol=1e-6)


def test_stages_and_their_parameters(run):
    _, world = run
    assert world[0]["stages"] == [0, 0, 0, 1, 1]
    # stage 0: the embedding and two Linears; stage 1: a Linear and the
    # embedding again (the head)
    assert world[0]["own"] == 1 + 2 * 2
    assert world[1]["own"] == 2 + 1


def test_fleet_wraps_the_internal_pipeline(run):
    _, world = run
    for r in world:
        assert r["llama_wrapper"] == "PipelineParallel"
        assert r["mb_override"] == 2 and r["cfg_microbatches"] is None
        assert r["llama_microbatches"] == 2
        assert np.isfinite(r["llama_losses"]).all()
        assert r["llama_losses"][1] < r["llama_losses"][0]
    assert world[0]["llama_losses"] == world[1]["llama_losses"]
