"""The port's LM serving engine (``repro_torch.launch.serve``) against the
reference package's ``launch/serve.py``.

Both engines serve the same requests with the same float32 weights (a
tree of the reference's structure, carried into the port by
``params_from_reference``); their greedy token streams must be equal, token for token, with
prompts of unequal lengths and slots refilled.  Both decode every slot at
the largest slot position (``ROADMAP.md`` queue 3, fault 5), which the
streams therefore exercise; ``test_fault5_*`` shows the fault itself.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import base as r_base
from repro.launch.serve import Request as RRequest
from repro.launch.serve import ServeEngine as RServeEngine
from repro.models.model import Model as RModel
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model

PROMPT_LENS = (5, 9, 3, 7, 4)
MAX_NEW = (4, 6, 3, 5, 4)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pair(arch, n_layers=2):
    """Reduced float32 models of both packages on the same seeded weights:
    a tree of the reference's structure (``jax.eval_shape`` of its
    ``init_params``) holding numpy values, weights normal over
    sqrt(fan-in) and norm scales 1 plus noise."""
    ref_cfg = dataclasses.replace(
        r_base.get_config(arch).reduced(n_layers=n_layers), dtype=jnp.float32)
    cfg = dataclasses.replace(base.get_config(arch).reduced(n_layers=n_layers),
                              dtype=torch.float32)
    rm = RModel(ref_cfg, remat=False)
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            value = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        else:
            value = rng.standard_normal(spec.shape) * spec.shape[-2] ** -0.5
        return value.astype(spec.dtype)

    tree = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(rm.init_params, jax.random.PRNGKey(0)))
    pm = Model(cfg, device="cpu")
    return (pm, params_from_reference(pm, tree), rm,
            jax.tree.map(jnp.asarray, tree))


def _drive(engine, requests, limit=200):
    """``main``'s loop: fill free slots, step, until every request is
    done."""
    pending = list(requests)
    steps = 0
    while pending or any(r is not None for r in engine.active):
        while pending and engine.submit(pending[0]):
            pending.pop(0)
        engine.step()
        steps += 1
        assert steps < limit
    return steps


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_token_streams_are_the_reference(arch):
    pm, pp, rm, rp = _pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, pm.cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    ours = [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    theirs = [RRequest(i, p, m) for i, (p, m) in
              enumerate(zip(prompts, MAX_NEW))]
    steps = _drive(ServeEngine(pm, pp, batch_slots=2, max_len=32), ours)
    rsteps = _drive(RServeEngine(rm, rp, batch_slots=2, max_len=32), theirs)
    assert steps == rsteps
    assert all(r.done and len(r.out) == r.max_new for r in ours)
    assert [[int(t) for t in r.out] for r in ours] == \
        [[int(t) for t in r.out] for r in theirs]


@pytest.mark.parametrize("arch,n_layers", [("hymba-1.5b", 4),
                                           ("xlstm-350m", 4),
                                           ("deepseek-v2-lite-16b", 3)])
def test_token_streams_of_the_other_kinds_are_the_reference(arch, n_layers):
    """Three requests through two slots (the third refills a slot), prompts
    of 5, 9 and 3 tokens: every cache leaf (hymba's KV, conv and ssm
    states with its meta tokens, xlstm's recurrent states, MLA's latents)
    goes through the per-slot scatter."""
    pm, pp, rm, rp = _pair(arch, n_layers)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pm.cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS[:3]]
    ours = [Request(i, p, m) for i, (p, m) in
            enumerate(zip(prompts, MAX_NEW))]
    theirs = [RRequest(i, p, m) for i, (p, m) in
              enumerate(zip(prompts, MAX_NEW))]
    steps = _drive(ServeEngine(pm, pp, batch_slots=2, max_len=32), ours)
    rsteps = _drive(RServeEngine(rm, rp, batch_slots=2, max_len=32), theirs)
    assert steps == rsteps
    assert all(r.done and len(r.out) == r.max_new for r in ours)
    assert [[int(t) for t in r.out] for r in ours] == \
        [[int(t) for t in r.out] for r in theirs]


def test_fault6_neither_engine_serves_the_vlm():
    """Neither engine passes ``image_embeds``, so the vlm kind fails in
    ``submit``: the reference in its cross-attention (``None.shape``),
    the port in ``Model.forward``, which names what is missing."""
    pm, pp, rm, rp = _pair("llama-3.2-vision-90b", 5)
    prompt = np.arange(4, dtype=np.int32)
    engine = ServeEngine(pm, pp, batch_slots=2, max_len=16)
    with pytest.raises(ValueError, match="needs image_embeds"):
        engine.submit(Request(0, prompt, 2))
    rengine = RServeEngine(rm, rp, batch_slots=2, max_len=16)
    with pytest.raises(AttributeError, match="'NoneType' object has no "
                                             "attribute 'shape'"):
        rengine.submit(RRequest(0, prompt, 2))


def test_fault5_decodes_a_short_slot_at_the_long_slots_position():
    """Two slots, prompts of 8 and 4 tokens: the step decodes both at
    position 8, so the short slot's logits are not its forward's column 4
    (rel-L2 0.67 with these weights, in both packages: the port
    reproduces the reference)."""
    pm, pp, rm, rp = _pair("qwen3-1.7b")
    rng = np.random.default_rng(8)
    long = rng.integers(0, 256, (8,)).astype(np.int32)
    short = rng.integers(0, 256, (4,)).astype(np.int32)
    engine = ServeEngine(pm, pp, batch_slots=2, max_len=16)
    rengine = RServeEngine(rm, rp, batch_slots=2, max_len=16)
    for e, cls in ((engine, Request), (rengine, RRequest)):
        assert e.submit(cls(0, long, 4)) and e.submit(cls(1, short, 4))
    assert int(engine.pos.max()) == 8 and engine.pos[1] == 4
    with torch.inference_mode():
        got, _ = pm.decode_step(engine.params,
                                torch.from_numpy(engine.next_tok),
                                engine.cache, int(engine.pos.max()))
    want, _ = rengine._decode(rengine.params, jnp.asarray(rengine.next_tok),
                              rengine.cache, jnp.asarray(8))
    assert rel(got, want) <= 1e-5
    # the short slot's own sequence through the full forward
    seq = np.concatenate([short, engine.next_tok[1, 0:1]])[None]
    full, _, _ = pm.forward(pp, torch.from_numpy(seq))
    rfull, _, _ = jax.jit(lambda p, s: rm.forward(p, s))(rp, jnp.asarray(seq))
    assert rel(full[0, 4], rfull[0, 4]) <= 1e-5
    wrong = rel(got[1, 0], full[0, 4])
    assert wrong > 0.1
    assert wrong == pytest.approx(rel(want[1, 0], rfull[0, 4]), rel=1e-3)
    # at its own position the short slot agrees with the forward
    one = pm.init_cache(1, 16)
    with torch.inference_mode():
        _, one = pm.prefill(pp, torch.from_numpy(short[None]), one)
        own, _ = pm.decode_step(pp, torch.from_numpy(seq[:, 4:]), one, 4)
    assert rel(own[0, 0], full[0, 4]) <= 1e-5


def test_main_serves_on_the_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--prompt-len", "6", "--max-new", "4",
                       "--max-len", "32"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("[serve] 3/3 requests, 12 tokens in ")
    assert out.endswith(" engine steps)")


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])


def test_serve_engine_completes_requests():
    """The reference's ``test_serve_engine_completes_requests`` on the
    port."""
    cfg = base.get_config("qwen3-1.7b").reduced(n_layers=1)
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator("cpu").manual_seed(0))
    engine = ServeEngine(model, params, batch_slots=2, max_len=32)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32),
                    max_new=4) for i in range(3)]
    pending = list(reqs)
    for _ in range(100):
        while pending and engine.submit(pending[0]):
            pending.pop(0)
        if engine.step() == 0 and not pending:
            break
    assert all(r.done for r in reqs)
    assert all(len(r.out) >= 4 for r in reqs)


def test_engine_casts_weights_once():
    cfg = base.get_config("musicgen-medium").reduced(n_layers=1)
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator("cpu").manual_seed(1))
    engine = ServeEngine(model, params, batch_slots=2, max_len=16)
    state = engine.params.state_dict()
    assert state["embed.table"].dtype == torch.bfloat16
    assert state["layers.0.mlp.up.w"].dtype == torch.bfloat16
    assert state["final_norm.scale"].dtype == torch.float32
    assert engine.cache["k"].dtype == torch.bfloat16
    prompt = np.zeros((5, cfg.n_codebooks), np.int32)
    req = Request(0, prompt, 3)
    assert engine.submit(req)
    while engine.step():
        pass
    assert req.done and [t.shape for t in req.out] == [(4,)] * 3


def test_batch_axis():
    assert serve._batch_axis((2, 3, 16, 4, 8), 3, (2, 1, 16, 4, 8)) == 1
    with pytest.raises(ValueError, match="no batch axis"):
        serve._batch_axis((2, 3, 16), 5, (2, 1, 16))


def test_scatter_walks_nested_caches():
    """Each leaf of a nested cache takes the one-slot cache's values at
    its own batch axis (the vlm's is the third)."""
    cache = {"self": {"k": torch.zeros(1, 4, 3, 5)},
             "mlstm": {"m": torch.zeros(2, 3, 4)}}
    small = {"self": {"k": torch.ones(1, 4, 1, 5)},
             "mlstm": {"m": torch.full((2, 1, 4), 2.0)}}
    serve._scatter(cache, small, 3, 1)
    assert cache["self"]["k"][:, :, 1].eq(1).all()
    assert cache["self"]["k"].sum() == 20
    assert cache["mlstm"]["m"][:, 1].eq(2).all()
    assert cache["mlstm"]["m"].sum() == 16
