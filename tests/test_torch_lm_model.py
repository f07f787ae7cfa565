"""The port's LM configs, data, decoder and LM formulas
(``repro_torch.configs``, ``data.pipeline``, ``models.model``,
``models.convert``, ``roofline.analysis``) against the reference
package's.

Both decoders compute with the same numbers: a parameter tree of the
reference's structure (``jax.eval_shape`` of its ``Model.init_params``)
holding seeded numpy values, carried into the port by
``params_from_reference``.  Tolerances (rel-L2): 1e-5 in float32 for every logit,
cache and aux value; 2e-2 in bfloat16 (the frameworks round intermediate
products at different points).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import base as r_base
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticTokens as RSyntheticTokens
from repro.models.model import Model as RModel
from repro.roofline import analysis as r_analysis
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import LATER_KINDS, Model
from repro_torch.roofline import analysis

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "gemma3-27b",
         "starcoder2-7b", "qwen3-1.7b", "internlm2-20b",
         "llama-3.2-vision-90b", "xlstm-350m", "hymba-1.5b",
         "musicgen-medium"]
#: the configs of the ported kinds, with the depth each test runs: two
#: layers where depth adds nothing, six for gemma (its global layer is
#: the sixth)
PORTED = {"qwen3-1.7b": 2, "internlm2-20b": 2, "starcoder2-7b": 2,
          "gemma3-27b": 6, "musicgen-medium": 2,
          "granite-moe-1b-a400m": 2}
F32_TOL = 1e-5
BF16_TOL = 2e-2


def rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(
        dtype, torch.dtype) else jnp.dtype(dtype).name


def fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = dtype_name(out["dtype"])
    return out


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_are_the_reference(arch):
    cfg, ref = base.get_config(arch), r_base.get_config(arch)
    assert isinstance(cfg.dtype, torch.dtype)
    assert fields(cfg) == fields(ref)
    assert fields(cfg.reduced()) == fields(ref.reduced())
    assert fields(cfg.reduced(n_layers=2, d_model=32)) == \
        fields(ref.reduced(n_layers=2, d_model=32))


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_input_specs_are_the_reference(arch):
    cfg, ref = base.get_config(arch), r_base.get_config(arch)
    for shape in r_base.SHAPES:
        assert base.shape_supported(cfg, shape) == \
            r_base.shape_supported(ref, shape)
        got, want = base.input_specs(cfg, shape), r_base.input_specs(ref, shape)
        assert set(got) == set(want)
        for name, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[name].shape)
            assert dtype_name(spec.dtype) == dtype_name(want[name].dtype)


def test_registry_and_shape_table_are_the_reference():
    assert base.list_configs() == r_base.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_base.SHAPES.items()}


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_codebooks", [0, 4])
def test_synthetic_tokens_are_the_reference(n_codebooks):
    kw = dict(vocab_size=5000, seq_len=33, global_batch=3, seed=7,
              n_codebooks=n_codebooks)
    got, want = SyntheticTokens(DataConfig(**kw)), \
        RSyntheticTokens(RDataConfig(**kw))
    for step in (0, 1, 17):
        a = got.batch(step)["tokens"]
        b = np.asarray(want.batch(step)["tokens"])
        assert a.dtype == torch.int32
        assert a.numpy().tobytes() == b.tobytes() and a.shape == b.shape
    first = next(iter(got))["tokens"]
    assert torch.equal(first, got.batch(0)["tokens"])


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------
def _configs(arch, dtype="float32"):
    n = PORTED[arch]
    ref = dataclasses.replace(r_base.get_config(arch).reduced(n_layers=n),
                              dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(base.get_config(arch).reduced(n_layers=n),
                              dtype=getattr(torch, dtype))
    return cfg, ref


_REFERENCE: dict = {}


def reference_tree(rm: RModel, seed: int) -> dict:
    """A parameter tree of the reference's structure, shapes and dtypes
    (``jax.eval_shape`` of its ``init_params``, which compiles nothing)
    holding seeded numpy values: weights normal over sqrt(fan-in), norm
    scales 1 plus noise."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            value = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        else:
            value = rng.standard_normal(spec.shape) * spec.shape[-2] ** -0.5
        return value.astype(spec.dtype)

    shapes = jax.eval_shape(rm.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _models(arch, dtype="float32"):
    """(port model, port params, reference model, reference params), the
    port's carried over from the reference's; cached for the module."""
    key = (arch, dtype)
    if key not in _REFERENCE:
        cfg, ref_cfg = _configs(arch, dtype)
        rm = RModel(ref_cfg, remat=False)
        tree = reference_tree(rm, 0)
        pm = Model(cfg, device="cpu")
        rp = jax.tree.map(jnp.asarray, tree)
        _REFERENCE[key] = (pm, params_from_reference(pm, tree), rm, rp, tree)
    return _REFERENCE[key][:4]


def _tokens(cfg, b, s, seed=0):
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", list(PORTED))
def test_params_from_reference_checks_every_leaf(arch):
    pm, pp, rm, rp = _models(arch)
    tree = _REFERENCE[(arch, "float32")][4]
    flat = dict(pp.state_dict())
    assert all(v.dtype == torch.float32 for v in flat.values())
    np.testing.assert_array_equal(flat["layers.1.attn.wq.w"].numpy(),
                                  tree["layers"]["attn"]["wq"]["w"][1])
    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="missing.*final_norm.scale"):
        params_from_reference(pm, missing)
    extra = dict(tree, bias={"b": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra.*bias.b"):
        params_from_reference(pm, extra)
    layers = jax.tree.map(lambda a: a[:1], tree["layers"])
    with pytest.raises(ValueError, match="missing.*layers.1"):
        params_from_reference(pm, dict(tree, layers=layers))
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["final_norm"] = {"scale": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_reference(pm, wrong)


@pytest.mark.parametrize("arch", list(PORTED))
def test_forward_prefill_decode_are_the_reference(arch):
    """float32, 2 sequences of 20 tokens: forward's logits and aux, a
    prefill of 18 and two decode steps, each step's logits and the cache."""
    pm, pp, rm, rp = _models(arch)
    tok = _tokens(pm.cfg, 2, 20)
    logits, aux, none = pm.forward(pp, torch.from_numpy(tok))
    rlogits, raux, _ = jax.jit(lambda p, t: rm.forward(p, t))(
        rp, jnp.asarray(tok))
    assert none is None and logits.shape == rlogits.shape
    assert rel(logits, rlogits) <= F32_TOL
    assert abs(float(aux) - float(raux)) <= F32_TOL * max(abs(float(raux)), 1)
    if pm.cfg.block_kind == "gqa_moe":
        assert float(aux) > 0.5

    cache, rcache = pm.init_cache(2, 32), rm.init_cache(2, 32)
    last, cache = pm.prefill(pp, torch.from_numpy(tok[:, :18]), cache)
    rlast, rcache = jax.jit(rm.prefill)(rp, jnp.asarray(tok[:, :18]), rcache)
    assert last.shape == rlast.shape and rel(last, rlast) <= F32_TOL
    step = jax.jit(rm.decode_step)
    for t in (18, 19):
        got, cache = pm.decode_step(pp, torch.from_numpy(tok[:, t:t + 1]),
                                    cache, t)
        want, rcache = step(rp, jnp.asarray(tok[:, t:t + 1]), rcache,
                            jnp.asarray(t))
        assert got.shape == want.shape and rel(got, want) <= F32_TOL
    for name in ("k", "v"):
        assert rel(cache[name], rcache[name]) <= F32_TOL
    if pm.cfg.block_kind != "gqa_moe":  # a one-token MoE pass drops tokens
        assert rel(got[:, 0], rlogits[:, 19]) <= 1e-4


@pytest.mark.parametrize("arch", list(PORTED))
def test_cache_shapes_are_the_reference(arch):
    cfg, ref_cfg = _configs(arch, "bfloat16")
    pm, rm = Model(cfg, device="cpu"), RModel(ref_cfg, remat=False)
    shapes = pm.cache_shapes(3, 40)
    want = rm.cache_shapes(3, 40)
    cache = pm.init_cache(3, 40)
    assert set(shapes) == set(want) == set(cache) == {"k", "v"}
    for name, spec in shapes.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == tuple(want[name].shape) == \
            tuple(cache[name].shape)
        assert spec.dtype == cache[name].dtype == torch.bfloat16
        assert dtype_name(want[name].dtype) == "bfloat16"
        assert not cache[name].any()


def test_gemma_layer_flags_are_the_reference():
    cfg = base.get_config("gemma3-27b")
    flags = Model(cfg, device="cpu")._layer_flags()
    want = RModel(r_base.get_config("gemma3-27b"))._layer_flags()
    assert flags == [bool(f) for f in np.asarray(want)]
    assert sum(flags) == 10 and flags[5] and not flags[4]


def test_bf16_forward_and_decode_within_bound():
    pm, pp, rm, rp = _models("qwen3-1.7b", "bfloat16")
    tok = _tokens(pm.cfg, 2, 12, seed=1)
    logits, _, _ = pm.forward(pp, torch.from_numpy(tok))
    rlogits, _, _ = jax.jit(lambda p, t: rm.forward(p, t))(
        rp, jnp.asarray(tok))
    assert logits.dtype == torch.bfloat16
    assert rel(logits, rlogits) <= BF16_TOL
    cache, rcache = pm.init_cache(2, 16), rm.init_cache(2, 16)
    _, cache = pm.prefill(pp, torch.from_numpy(tok[:, :11]), cache)
    _, rcache = jax.jit(rm.prefill)(rp, jnp.asarray(tok[:, :11]), rcache)
    got, _ = pm.decode_step(pp, torch.from_numpy(tok[:, 11:]), cache, 11)
    want, _ = jax.jit(rm.decode_step)(rp, jnp.asarray(tok[:, 11:]), rcache,
                                      jnp.asarray(11))
    assert rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-medium",
                                  "granite-moe-1b-a400m"])
def test_cast_once_equals_cast_at_use(arch):
    """bf16 compute over float32 weights (cast at every use, the
    reference's way) and over weights cast once give identical logits;
    norm scales and the router stay float32."""
    cfg, _ = _configs(arch, "bfloat16")
    pm = Model(cfg, device="cpu")
    params = pm.init_params(torch.Generator("cpu").manual_seed(3))
    cast = pm.cast_params(params)
    dtypes = {k: v.dtype for k, v in cast.state_dict().items()}
    assert dtypes["embed.table"] == dtypes["layers.0.attn.wq.w"] == \
        torch.bfloat16
    assert dtypes["layers.0.ln1.scale"] == torch.float32
    if cfg.block_kind == "gqa_moe":
        assert dtypes["layers.0.moe.router.w"] == torch.float32
        assert dtypes["layers.0.moe.up"] == torch.bfloat16
    assert pm.cast_params(cast) is cast
    tok = torch.from_numpy(_tokens(cfg, 2, 9, seed=2))
    assert torch.equal(pm.forward(params, tok)[0], pm.forward(cast, tok)[0])
    c1, c2 = pm.init_cache(2, 12), pm.init_cache(2, 12)
    l1, c1 = pm.prefill(params, tok[:, :8], c1)
    l2, c2 = pm.prefill(cast, tok[:, :8], c2)
    assert torch.equal(l1, l2)
    d1, _ = pm.decode_step(params, tok[:, 8:], c1, 8)
    d2, _ = pm.decode_step(cast, tok[:, 8:], c2, 8)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("kind", LATER_KINDS)
def test_kinds_not_ported_raise(kind):
    arch = next(a for a in ARCHS if base.get_config(a).block_kind == kind)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 7b"):
        Model(base.get_config(arch), device="cpu")


def test_sharded_model_raises():
    with pytest.raises(NotImplementedError, match="7d"):
        Model(base.get_config("qwen3-1.7b"), mesh=object(), device="cpu")


def test_init_params_needs_a_generator_on_the_device():
    cfg, _ = _configs("qwen3-1.7b")
    with pytest.raises(ValueError, match="generator"):
        Model(cfg, device="meta").init_params(torch.Generator("cpu"))


# --------------------------------------------------------------------------
# LM formulas
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_are_the_reference(arch):
    assert analysis.active_params(base.get_config(arch)) == \
        r_analysis.active_params(r_base.get_config(arch))
    for shape in r_base.SHAPES:
        assert analysis.model_flops(arch, shape) == \
            r_analysis.model_flops(arch, shape)


def test_active_params_of_the_served_configs():
    """qwen3-1.7b: 1.41 G parameters outside its 0.31 G (tied) embedding;
    granite: 377 M of 1.28 G active (8 of 32 experts)."""
    total, active = analysis.active_params(base.get_config("qwen3-1.7b"))
    assert total == active == 28 * (2 * 2048 * 2048 + 2 * 2048 * 1024
                                    + 3 * 2048 * 6144)
    total, active = analysis.active_params(
        base.get_config("granite-moe-1b-a400m"))
    assert (round(total / 1e6), round(active / 1e6)) == (1283, 377)
