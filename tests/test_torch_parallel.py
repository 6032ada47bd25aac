"""Port parity for the mesh and the sharding rules
(unilm_tpu_torch.parallel.mesh / sharding) and the mesh layouts.

- The rule decides, parameter for parameter, the axis JAX's
  `infer_param_shardings` decides, for every parameter of the models
  JAX's tests/test_sharding_coverage.py covers that the port has (RetNet
  is not ported) and of an MoE UniGPT, under three meshes of the 8 forced
  CPU devices; the port applies it on torch's layout (a Dense weight is
  the transposed flax kernel), built on the meta device.
- `make_mesh`'s axis sizes and errors are JAX's.
- On four gloo CPU ranks (one spawn, tests/torch_dist_workers.py): an
  MoE UniGPT trained 2 AdamW steps with experts on `expert` (EP) and on
  data x fsdp x tensor gives the one-rank loss, overflow, grad norm and
  parameters (float32; 1e-5 relative on the metrics, 1e-5 absolute on the
  parameters after the steps), the tensor axis splitting the products.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from unilm_tpu.parallel import infer_param_shardings
from unilm_tpu.parallel import make_mesh as jmake_mesh
from unilm_tpu.parallel.mesh import make_mesh as jmesh_of
from unilm_tpu_torch.parallel import mesh as tmesh
from unilm_tpu_torch.parallel.sharding import (_flax_path, flax_view,
                                               param_specs)

torch.set_num_threads(1)

PORT_NAMES = {"beit_base": "beit_base_patch16_224",
              "layoutlmv3_base": "layoutlmv3_base", "trocr_base": "trocr_base",
              "kosmos2_5": "kosmos2_5", "yoco_base": "yoco_base",
              "beit3_base": "beit3_base"}
MESHES = {"fsdp8": {"fsdp": 8}, "fsdp4_tensor2": {"fsdp": 4, "tensor": 2},
          "tensor2_expert2_fsdp2": {"tensor": 2, "expert": 2, "fsdp": 2}}


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    if name == "unigpt_moe":
        from unilm_tpu.models import kosmos as jk

        cfg = jk.UniGPTConfig(**W.MOE_KW)
        return jax.eval_shape(lambda r: jk.UniGPT(cfg).init(
            r, jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))["params"]
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import test_sharding_coverage as cov

    return cov.MODELS[name]()


def _port_model(name):
    if name == "unigpt_moe":
        from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig

        return UniGPT(UniGPTConfig(**W.MOE_KW), device="meta")
    from unilm_tpu_torch.models import registry

    return registry.build(PORT_NAMES[name], device="meta")[1]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(PORT_NAMES) + ["unigpt_moe"])
def test_rule_decides_as_jax_for_every_parameter(name, mesh_name):
    mesh = jmake_mesh(MESHES[mesh_name])
    params = _jax_tree(name)
    sh = infer_param_shardings(params, mesh)
    want, shapes = {}, {}
    for (path, leaf), s in zip(jax.tree_util.tree_leaves_with_path(params),
                               jax.tree_util.tree_leaves(sh)):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        spec = tuple(s.spec)
        want[keys] = spec + (None,) * (leaf.ndim - len(spec))
        shapes[keys] = tuple(leaf.shape)
    model = _port_model(name)
    got = param_specs(model, dict(mesh.shape))
    seen = set()
    sharded = 0
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf, fshape, to_torch = flax_view(mod, pname, p.shape)
            path = _flax_path(mname) + (leaf,)
            assert path in want, path
            assert tuple(fshape) == shapes[path], path
            seen.add(path)
            expect = [None] * p.dim()
            for fd, axis in enumerate(want[path]):
                if axis is not None:
                    assert to_torch[fd] is not None, path
                    expect[to_torch[fd]] = axis
            key = f"{mname}.{pname}" if mname else pname
            assert got[key] == tuple(expect), (key, got[key], expect)
            sharded += any(a is not None for a in expect)
    assert seen == set(want)
    assert sharded > 0
    if name == "unigpt_moe" and "expert" in MESHES[mesh_name]:
        assert got["decoder.layers.1.moe.experts.fc1.weight"][0] == "expert"


def test_mesh_sizes_and_errors_are_jaxs():
    devs = jax.devices()[:8]
    for sizes in ({"data": -1}, {"fsdp": 2, "tensor": -1},
                  {"stage": 2, "fsdp": 2, "expert": 2}):
        assert tmesh.mesh_sizes(sizes, 8) == dict(jmesh_of(sizes,
                                                           devices=devs).shape)
    assert tmesh.MESH_AXES == ("stage", "data", "fsdp", "tensor", "expert",
                               "seq")
    for sizes in ({"bogus": 2}, {"data": -1, "fsdp": -1}, {"fsdp": 3},
                  {"fsdp": 3, "data": -1}):
        with pytest.raises(ValueError) as jerr:
            jmesh_of(sizes, devices=devs)
        with pytest.raises(ValueError) as terr:
            tmesh.mesh_sizes(sizes, 8)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh({"data": -1})


# name: (mesh axis sizes, MOE_KW overrides); without the sub-LN the
# tensor split keeps each rank's heads and FFN features through to the
# row-parallel projection (Megatron's pair)
LAYOUTS = {"ep": ({"expert": 2, "data": 2}, {}),
           "fsdp_tensor": ({"data": 1, "fsdp": 2, "tensor": 2}, {}),
           "ep_fsdp": ({"expert": 2, "fsdp": 2}, {}),
           "tensor_no_subln": ({"tensor": 2, "data": 2}, {"subln": False})}


@pytest.fixture(scope="module")
def layout_ranks(tmp_path_factory):
    return W.spawn("mesh_layouts", 4, tmp_path_factory.mktemp("layouts"),
                   layouts=LAYOUTS)


@functools.lru_cache(maxsize=None)
def _one_rank(subln=True):
    return W.moe_lm(None, subln=subln)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_trains_as_one_rank(layout_ranks, layout):
    want = _one_rank(**LAYOUTS[layout][1])
    for r, res in enumerate(layout_ranks):
        got = res[layout]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in ("loss", "grad_norm", "moe_overflow"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"rank {r} step {i} {k}")
        # FSDP2 holds every parameter as a DTensor over data x fsdp
        assert got["param_types"] == ["DTensor"]
        assert set(got["params"]) == set(want["params"])
        for n, t in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), t.numpy(),
                                       atol=1e-5, err_msg=f"rank {r} {n}")


def test_tensor_axis_splits_the_products(layout_ranks):
    """Under a tensor axis of 2 every q/k/v/fc1 projection, the experts'
    fc1 included, is a column split and every out_proj/fc2 a row split,
    each reading its half of the features (Megatron-LM's split, JAX's
    GSPMD under the same rule), and self-attention attends over its half
    of the heads; without a tensor axis none is."""
    E, Fd = W.MOE_KW["embed_dim"], W.MOE_KW["ffn_dim"]
    X = W.MOE_KW["moe_experts"]
    want = {}
    for i in range(W.MOE_KW["num_layers"]):
        pre = f"decoder.layers.{i}."
        for p in ("q_proj", "k_proj", "v_proj"):
            want[f"{pre}self_attn.{p}"] = ("column", (E // 2, E))
        want[f"{pre}self_attn.out_proj"] = ("row", (E, E // 2))
        ffn = (f"{pre}moe.experts." if (i + 1) % W.MOE_KW["moe_freq"] == 0
               else f"{pre}ffn.")
        lead = (X,) if "experts" in ffn else ()
        want[f"{ffn}fc1"] = ("column", lead + (Fd // 2, E))
        want[f"{ffn}fc2"] = ("row", lead + (E, Fd // 2))
    attn = sorted(f"decoder.layers.{i}.self_attn"
                  for i in range(W.MOE_KW["num_layers"]))
    for res in layout_ranks:
        for name in ("fsdp_tensor", "tensor_no_subln"):
            assert res[name]["splits"] == want
            assert res[name]["heads_split"] == attn
        assert res["ep"]["splits"] == {}
        assert res["ep"]["heads_split"] == []


@pytest.mark.parametrize("name", sorted(W.SERVE_MESHES))
def test_tensor_parallel_serving_gives_one_rank_tokens(layout_ranks, name):
    """ServingEngine(mesh=...) with the heads split over the tensor axis
    (pools of H / tp heads, parameters placed by the rules; int8 KV with a
    replicated scale sidecar) emits the one-rank engine's greedy streams
    on every rank, MoE layers included."""
    want = W.serve(None, W.SERVE_MESHES[name][1])
    for r, res in enumerate(layout_ranks):
        assert res["serve"][name] == want, (r, name)


def test_dryrun_multichip_4():
    """parallel/dryrun.py on 4 gloo CPU ranks: the EP and data x fsdp x
    tensor layouts' losses within 1e-5 of the one-rank loss, the ring
    against dense attention, the pipeline LM, stage x fsdp PipelineGPT and
    SeqParallelLM against their one-rank models."""
    from unilm_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4)
    assert [s for s, _ in res["layouts"]] == [
        {"expert": 2, "data": 2}, {"data": 1, "fsdp": 2, "tensor": 2}]
    for _, loss in res["layouts"]:
        np.testing.assert_allclose(loss, res["one_rank"], rtol=1e-5)
    for key in ("pipeline_lm", "pipeline_gpt", "seq_lm"):
        np.testing.assert_allclose(*res[key], rtol=1e-5, err_msg=key)
