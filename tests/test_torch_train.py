"""The port's training path (``repro_torch.train``, ``Model.loss_fn`` and
remat, ``models.convert``'s way back to the reference's layout) against
the reference package's.

The first half is the port's counterpart of every case of the
reference's ``tests/test_train.py``.  The second holds the port against
the reference on the same numpy inputs: parameter trees of the
reference's structure (``test_torch_lm_model.reference_tree``) carried
into the port by ``params_from_reference`` and back by
``params_to_reference``.

Tolerances, each stated where it is used:
- ``schedule``: 1e-6 relative (float32 against the reference's float32, or
  float64 where the tests' x64 widens its Python-float products);
- ``adamw_update``: 1e-6 relative per leaf (summation order in the norm
  and ``addcmul``);
- ``compress_tree``: int8 equal except a ±1 where the quotient lies within
  a float32 ulp of a half; scales 1e-7 relative;
- ``loss_fn`` in float32: the loss within 1e-5 · max(|loss|, 1), every
  gradient leaf within 1e-4 rel-L2 (measured at most 6.7e-6, hymba's
  ``mamba.wx_bc``);
- remat against none: 1e-6 rel-L2 per gradient leaf (the same ops
  recomputed; measured 0 on the CPU);
- blocked attention's gradients over fully masked blocks and rows:
  finite, 1e-5 rel-L2;
- training trajectories across the packages: parameters within 1e-4
  rel-L2 per leaf after three or six AdamW steps (see
  ``TRAJECTORY_TOL``).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import base as r_base
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticTokens as RSyntheticTokens
from repro.models.model import Model as RModel
from repro.train import compression as r_compression
from repro.train import optimizer as r_opt
from repro.train.checkpoint import CheckpointManager as RCheckpointManager
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import build_train_step as r_build_train_step
from repro_torch.configs import base
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import model as model_mod
from repro_torch.models.convert import (flat_reference,
                                        opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference, reference_key)
from repro_torch.models.model import Model
from repro_torch.train import compression
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (OptConfig, _decay_mask,
                                         adamw_update, global_norm,
                                         init_opt_state, schedule)
from repro_torch.train.trainer import (TrainConfig, Trainer,
                                       build_train_step, value_and_grad)

from test_torch_lm_model import (ARCHS, PORTED, _configs, _images, _tokens,
                                 reference_tree)

#: parameters of the two packages after the same AdamW steps from the same
#: float32 weights and batches.  Adam's first steps move each weight by
#: about lr whatever its gradient's size, so a weight whose gradient the
#: two packages round to opposite signs moves 2 lr apart; at these sizes
#: no such weight shows: measured 4.5e-7 (``mlp.gate.w``) after three
#: steps from converted parameters, 1.5e-8 across the restarts.
TRAJECTORY_TOL = 1e-4


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


def _leaves(tree) -> dict:
    """A nested tree's leaves by their ``/``-joined path, as numpy."""
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float64) if np.asarray(leaf).dtype.kind
            == "f" else np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _worst(got_tree, want_tree) -> tuple[float, str]:
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert set(got) == set(want)
    return max((rel(got[k], want[k]), k) for k in want)


# --------------------------------------------------------------------------
# the reference's tests/test_train.py, on the port
# --------------------------------------------------------------------------
def test_adamw_reduces_quadratic():
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(cfg, params, grads, state)
    assert float((params["w"] ** 2).sum()) < 1e-2
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 100


def test_schedule_warmup_and_decay():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert float(schedule(cfg, 0)) < 0.2
    assert abs(float(schedule(cfg, 10)) - 1.0) < 0.1
    assert float(schedule(cfg, torch.tensor(100))) <= 0.11


def test_grad_clipping():
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    huge = {"w": torch.full((4,), 1e6)}
    new_params, _, m = adamw_update(cfg, params, huge, state)
    assert float(m["grad_norm"]) > 1e5
    assert torch.isfinite(new_params["w"]).all()


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    """A float32 and a bf16 leaf (written as raw 2-byte values, read back
    as bf16 under a bf16 template) and the int32 step."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.tensor([1.0, -2.5, 3.0, 0.0078125],
                                           dtype=torch.bfloat16)}}
    opt = init_opt_state(params)
    opt["m"]["nested.b"] += 0.5
    for step in (10, 20, 30):
        mgr.save(step, params, opt, extra={"data_step": step})
    assert mgr.all_steps() == [20, 30]  # rotated
    template = {"a": torch.zeros(2, 3),
                "nested": {"b": torch.zeros(4, dtype=torch.bfloat16)}}
    p2, o2, manifest = mgr.restore(template, init_opt_state(params))
    assert manifest["step"] == 30 and manifest["data_step"] == 30
    assert torch.equal(p2["a"], params["a"])
    assert p2["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(p2["nested"]["b"], params["nested"]["b"])
    assert o2["step"].dtype == torch.int32
    assert torch.equal(o2["m"]["nested.b"], opt["m"]["nested.b"])
    with np.load(tmp_path / "step_00000030" / "params.npz") as z:
        assert z["nested/b"].dtype == np.dtype("V2")


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.ones(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones(3)
    mgr.save_async(5, {"w": w})
    w.fill_(7.0)  # the host copy was taken before the thread started
    mgr.wait()
    assert mgr.latest_step() == 5
    p, _, _ = mgr.restore({"w": torch.zeros(3)})
    assert torch.equal(p["w"], torch.ones(3))


def test_compression_error_feedback_converges():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, 64).astype(np.float32))}
    residual = compression.init_residual(g)
    total_true = np.zeros(64)
    total_comp = np.zeros(64)
    for _ in range(50):
        (q, s), residual = compression.compress_tree(g, residual)
        deq = compression.decompress_tree(q, s)
        total_true += g["w"].numpy()
        total_comp += deq["w"].numpy()
    # error feedback keeps the cumulative sum unbiased
    np.testing.assert_allclose(total_comp, total_true, rtol=0, atol=0.2)
    assert q["w"].dtype == torch.int8


def _tiny_setup(tmp_path, steps=6, **tkw):
    cfg = base.get_config("qwen3-1.7b").reduced(n_layers=2)
    model = Model(cfg, device="cpu", remat=False)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4))
    tcfg = TrainConfig(steps=steps, checkpoint_every=3,
                       checkpoint_dir=str(tmp_path), log_every=100,
                       opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=steps), **tkw)
    return model, data, tcfg


def test_trainer_loss_decreases(tmp_path):
    model, data, tcfg = _tiny_setup(tmp_path, steps=30)
    tcfg.checkpoint_every = 1000
    out = Trainer(model, data, tcfg).run(verbose=False)
    params0 = model.init_params(torch.Generator("cpu").manual_seed(0))
    with torch.no_grad():
        l0 = float(model.loss_fn(params0, data.batch(0))[0])
    assert out["step"] == 30
    assert out["loss"] < l0, (out["loss"], l0)


def test_trainer_checkpoint_restart_resumes(tmp_path):
    model, data, tcfg = _tiny_setup(tmp_path, steps=3)
    out1 = Trainer(model, data, tcfg).run(verbose=False)
    assert out1["step"] == 3
    tcfg.steps = 6
    out2 = Trainer(model, data, tcfg).run(verbose=False)
    assert out2["step"] == 6
    assert CheckpointManager(str(tmp_path)).latest_step() == 6


def test_trainer_preemption_checkpoints_and_resumes(tmp_path):
    model, data, tcfg = _tiny_setup(tmp_path, steps=50)

    class PreemptingData:
        def __init__(self, inner, trainer_box, at):
            self.inner, self.box, self.at = inner, trainer_box, at

        def batch(self, step):
            if step >= self.at:
                self.box[0]._stop = True  # a SIGTERM mid-run
            return self.inner.batch(step)

    box = [None]
    tr = Trainer(model, PreemptingData(data, box, at=4), tcfg)
    box[0] = tr
    out = tr.run(verbose=False)
    assert out["preempted"] and out["step"] == 5
    assert CheckpointManager(str(tmp_path)).latest_step() == 5
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        assert json.load(f) == {"step": 5, "preempted": True}
    tcfg.steps = 7
    out2 = Trainer(model, data, tcfg).run(verbose=False)
    assert out2["step"] == 7 and not out2["preempted"]


def test_trainer_grad_compression_runs(tmp_path):
    model, data, tcfg = _tiny_setup(tmp_path, steps=4, grad_compression=True)
    out = Trainer(model, data, tcfg).run(verbose=False)
    assert out["step"] == 4 and np.isfinite(out["loss"])


def test_trainer_microbatch_equivalence():
    """2 microbatches == 1 full batch (the same grads up to rounding)."""
    cfg = base.get_config("qwen3-1.7b").reduced(n_layers=1)
    model = Model(cfg, device="cpu", remat=False)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=4))
    batch = data.batch(0)
    runs = []
    for mb in (1, 2):
        params = model.init_params(torch.Generator("cpu").manual_seed(0))
        step = build_train_step(model, OptConfig(lr=1e-3), microbatches=mb)
        runs.append(step(params, init_opt_state(params), batch)[0])
    d = max(float((a - b).detach().abs().max()) for a, b in
            zip(runs[0].parameters(), runs[1].parameters()))
    assert d < 5e-2, d  # bf16 compute; the loss means differ by microbatch


def test_straggler_watchdog():
    t = Trainer.__new__(Trainer)
    t.cfg = TrainConfig(straggler_factor=2.0)
    t._step_times, t.stragglers = [], []
    for step, dt in enumerate([1, 1, 1, 1, 1, 5, 1]):
        t._watchdog(step, dt)
    assert t.stragglers == [5]


def test_trainer_and_model_refuse_a_mesh(tmp_path):
    """The trainer takes a mesh only with a model built on it."""
    from repro_torch.launch.mesh import make_mesh

    model, data, tcfg = _tiny_setup(tmp_path)
    with pytest.raises(ValueError, match="not built on"):
        Trainer(model, data, tcfg, mesh=make_mesh((2, 2),
                                                  ("data", "model")))


# --------------------------------------------------------------------------
# the optimizer and compression against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    OptConfig(lr=3e-4, warmup_steps=100, total_steps=1000),
    OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
    OptConfig(lr=1.0, warmup_steps=0, total_steps=7, min_lr_frac=0.0)])
def test_schedule_is_the_reference(cfg):
    ref = r_opt.OptConfig(**dataclasses.asdict(cfg))
    for step in range(cfg.total_steps + 1):
        got = float(schedule(cfg, step))
        want = float(r_opt.schedule(ref, jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * abs(want), (step, got, want)


def _grads_like(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape))
                        .astype(np.float32), tree)


@pytest.mark.parametrize("clip_norm", [1.0, 1e4])
def test_adamw_update_is_the_reference(clip_norm):
    """Three steps on reduced granite-moe's parameters (stacked norms,
    expert tables, the top-level final norm) with seeded gradients:
    every parameter and moment within 1e-6 rel-L2, the norm and lr."""
    cfg, ref_cfg = _configs("granite-moe-1b-a400m", n_layers=2)
    rm = RModel(ref_cfg, remat=False)
    tree = reference_tree(rm, 0)
    pm = Model(cfg, device="cpu")
    params = params_from_reference(pm, tree)
    state = init_opt_state(params)
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                    clip_norm=clip_norm)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = r_opt.init_opt_state(rparams)
    rupdate = jax.jit(lambda p, g, s: r_opt.adamw_update(
        r_opt.OptConfig(**dataclasses.asdict(opt)), p, g, s))
    for step in range(3):
        g = _grads_like(tree, step, scale=3.0)
        grads = {k: torch.from_numpy(np.array(v))
                 for k, v in flat_reference(g).items()}
        params, state, m = adamw_update(opt, params, grads, state)
        rparams, rstate, rm_ = rupdate(rparams, jax.tree.map(jnp.asarray, g),
                                       rstate)
        assert rel(float(m["grad_norm"]), float(rm_["grad_norm"])) <= 1e-6
        assert rel(float(m["lr"]), float(rm_["lr"])) <= 1e-6
    assert _worst(params_to_reference(params), rparams)[0] <= 1e-6
    got = opt_state_to_reference(state)
    assert int(got["step"]) == int(rstate["step"]) == 3
    for part in ("m", "v"):
        assert _worst(got[part], rstate[part])[0] <= 1e-6, part


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_is_the_reference(arch):
    """Fault 7 of the reference: its mask tests rank >= 2 on the stacked
    leaf, so every norm scale inside a stack is decayed and only the
    top-level vectors are not; the port's mask equals it, name for name."""
    cfg, ref_cfg = _configs(arch)
    shapes = jax.eval_shape(RModel(ref_cfg, remat=False).init_params,
                            jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in _leaves(jax.tree.map(
        lambda s: s.ndim >= 2, shapes)).items()}
    got = _decay_mask(Model(cfg, device="cpu").abstract_params())
    for name, value in got.items():
        assert value == want[reference_key(name)[0]], name
    assert {reference_key(n)[0] for n in got} == set(want)
    assert got["final_norm.scale"] == 0.0
    stacked_norms = [n for n in got if n.endswith(".scale")
                     and reference_key(n)[1]]
    assert stacked_norms and all(got[n] == 1.0 for n in stacked_norms)


def test_compress_tree_is_the_reference():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((33, 17)).astype(np.float32),
         "b": (rng.standard_normal(100) * 1e-3).astype(np.float32),
         "c": np.full(8, 0.25, np.float32)}
    r = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
         for k, v in g.items()}
    (q, s), res = compression.compress_tree(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()})
    (rq, rs), rres = r_compression.compress_tree(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    for k in g:
        qi, rqi = q[k].numpy().astype(int), np.asarray(rq[k]).astype(int)
        assert q[k].dtype == torch.int8
        assert rel(float(s[k]), float(rs[k])) <= 1e-7
        off = qi != rqi
        assert np.abs(qi - rqi).max() <= 1
        # a differing value only where the quotient is a half within an ulp
        quot = (g[k] + r[k]) / np.float32(rs[k])
        frac = np.abs(np.abs(quot[off]) % 1 - 0.5)
        assert np.all(frac <= 4 * np.spacing(np.abs(quot[off]))), k
        assert rel(res[k].numpy(), np.asarray(rres[k])) <= 1e-5
    # half to even in both
    q1, _ = compression.quantize(torch.tensor([127.0, 0.5, 1.5, -2.5]))
    rq1, _ = r_compression.quantize(jnp.asarray([127.0, 0.5, 1.5, -2.5]))
    assert q1.tolist() == np.asarray(rq1).tolist() == [127, 0, 2, -2]


# --------------------------------------------------------------------------
# convert: the way back
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_reference_inverts_params_from_reference(arch):
    cfg, ref_cfg = _configs(arch)
    tree = reference_tree(RModel(ref_cfg, remat=False), 1)
    pm = Model(cfg, device="cpu")
    back = params_to_reference(params_from_reference(pm, tree))
    got, want = _leaves(back), _leaves(tree)
    assert list(got) == list(want)  # the reference's leaf order
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    state = init_opt_state(params_from_reference(pm, tree))
    state["m"] = {k: v + 1 for k, v in state["m"].items()}
    rstate = opt_state_to_reference(state)
    again = opt_state_from_reference(rstate, init_opt_state(
        params_from_reference(pm, tree)))
    assert all(torch.equal(again["m"][k], state["m"][k]) for k in state["m"])


def test_reference_key():
    assert reference_key("layers.3.attn.wq.w") == ("layers/attn/wq/w", (3,))
    assert reference_key("units.1.self.2.ln1.scale") == \
        ("units/self/ln1/scale", (1, 2))
    assert reference_key("units.1.cross.gate") == ("units/cross/gate", (1,))
    assert reference_key("final_norm.scale") == ("final_norm/scale", ())
    assert reference_key("nested.b") == ("nested/b", ())


# --------------------------------------------------------------------------
# loss, gradients and remat against the reference
# --------------------------------------------------------------------------
def _batch(cfg, b=2, s=20, seed=0):
    tok = _tokens(cfg, b, s, seed)
    img, rimg = _images(cfg, b, seed)
    batch, rbatch = {"tokens": torch.from_numpy(tok)}, \
        {"tokens": jnp.asarray(tok)}
    if img is not None:
        batch["image_embeds"], rbatch["image_embeds"] = img, rimg
    return batch, rbatch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_are_the_reference(arch):
    """float32, reduced, 2 sequences of 20 tokens: the loss within 1e-5 ·
    max(|loss|, 1), aux likewise, every gradient leaf within 1e-4 rel-L2
    of ``jax.value_and_grad(Model.loss_fn)``."""
    cfg, ref_cfg = _configs(arch)
    rm = RModel(ref_cfg, remat=False)
    tree = reference_tree(rm, 0)
    pm = Model(cfg, device="cpu")
    params = params_from_reference(pm, tree)
    batch, rbatch = _batch(cfg)
    (total, met), grads = value_and_grad(pm, params, batch)
    (rtotal, rmet), rgrads = jax.jit(jax.value_and_grad(
        rm.loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, tree), rbatch)
    for got, want in ((total, rtotal), (met["loss"], rmet["loss"]),
                      (met["aux"], rmet["aux"])):
        assert abs(float(got) - float(want)) <= 1e-5 * max(abs(float(want)),
                                                           1.0)
    worst, leaf = _worst(params_to_reference(grads), rgrads)
    assert worst <= 1e-4, (leaf, worst)
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "hymba-1.5b",
                                  "xlstm-350m", "llama-3.2-vision-90b"])
def test_remat_equals_no_remat(arch, monkeypatch):
    """At 4 layers (the vlm: one unit of 5; xlstm: two units) every
    gradient leaf and the loss with remat equal those without (1e-6),
    and remat ran a checkpoint per layer or unit."""
    n = {"llama-3.2-vision-90b": 5}.get(arch, 4)
    cfg, _ = _configs(arch, n_layers=n)
    calls = []
    real = model_mod.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(model_mod, "checkpoint", counting)
    base_m = Model(cfg, device="cpu", remat=False)
    params = base_m.init_params(torch.Generator("cpu").manual_seed(2))
    batch, _ = _batch(cfg, seed=1)
    (l0, _), g0 = value_and_grad(base_m, params, batch)
    assert not calls
    on = Model(cfg, device="cpu", remat=True)
    assert on.remat
    (l1, _), g1 = value_and_grad(on, params, batch)
    kind = cfg.block_kind
    want = n // cfg.cross_every if kind == "vlm" else \
        n // 2 if kind == "xlstm" else n
    assert len(calls) == want
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    for k in g0:
        assert rel(g1[k].numpy(), g0[k].numpy()) <= 1e-6, k
    # no remat without autograd or with a cache
    calls.clear()
    with torch.no_grad():
        on.forward(params, batch["tokens"],
                   image_embeds=batch.get("image_embeds"))
    assert not calls
    assert not Model(dataclasses.replace(cfg, n_layers=2),
                     device="cpu").remat


@pytest.mark.parametrize("kv_len", [None, 5])
def test_blocked_attention_grads_are_finite_and_the_reference(kv_len):
    """Blocks of 4 over 12 positions with a window of 3: whole (query
    block, key block) pairs are masked (finite ``NEG_INF``, divided by
    ``max(l, 1e-30)``), and with ``kv_len`` 5 the rows past it see no
    key.  The gradients of q, k and v are finite and within 1e-5 rel-L2 of
    the reference's."""
    from repro.models import attention as r_attn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(7)
    q, k, v, w = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (2, 12, 4, 8), (2, 12, 2, 8), (2, 12, 2, 8), (2, 12, 4, 8)))
    kw = dict(causal=True, window=3, kv_len=kv_len, block_q=4, block_k=4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (attn.blocked_attention(tq, tk, tv, **kw) * torch.from_numpy(w)) \
        .sum().backward()
    want = jax.grad(lambda a, b, c: jnp.sum(r_attn.blocked_attention(
        a, b, c, **kw) * w), argnums=(0, 1, 2))(q, k, v)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.isfinite(got).all()
        assert rel(got.numpy(), ref) <= 1e-5


def test_train_steps_are_the_reference():
    """Three ``build_train_step`` steps of reduced qwen3-1.7b (float32, 2
    layers, weight decay on) from converted parameters against the
    reference's jitted steps on the same batches: each step's loss within
    1e-5, the parameters within ``TRAJECTORY_TOL`` per leaf."""
    cfg, ref_cfg = _configs("qwen3-1.7b", n_layers=2)
    rm = RModel(ref_cfg, remat=False)
    tree = reference_tree(rm, 0)
    pm = Model(cfg, device="cpu")
    params = params_from_reference(pm, tree)
    state = init_opt_state(params)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    step = build_train_step(pm, opt)
    rstep = jax.jit(r_build_train_step(rm, r_opt.OptConfig(
        **dataclasses.asdict(opt))))
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = r_opt.init_opt_state(rparams)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                      global_batch=4))
    for i in range(3):
        batch = data.batch(i)
        params, state, m = step(params, state, batch)
        rparams, rstate, rm_ = rstep(rparams, rstate,
                                     {"tokens": jnp.asarray(batch["tokens"])})
        assert abs(float(m["loss"]) - float(rm_["loss"])) <= 1e-5 * float(
            rm_["loss"])
    worst, leaf = _worst(params_to_reference(params), rparams)
    assert worst <= TRAJECTORY_TOL, (leaf, worst)


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------
def test_checkpoint_layout_is_the_reference(tmp_path):
    """The same parameters and AdamW state saved by both managers: the
    same files, the same npz keys in the same order with the same dtypes
    and shapes and values, the same manifest text; and each manager
    restores the other's checkpoint."""
    cfg, ref_cfg = _configs("llama-3.2-vision-90b")
    rm = RModel(ref_cfg, remat=False)
    tree = reference_tree(rm, 0)
    pm = Model(cfg, device="cpu")
    params = params_from_reference(pm, tree)
    state = init_opt_state(params)
    state["v"] = {k: v + 2 for k, v in state["v"].items()}
    state["step"] = torch.tensor(7, dtype=torch.int32)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = {"m": r_opt.init_opt_state(rparams)["m"],
              "v": jax.tree.map(lambda a: a + 2,
                                r_opt.init_opt_state(rparams)["v"]),
              "step": jnp.asarray(7, jnp.int32)}
    CheckpointManager(str(tmp_path / "port")).save(
        7, params, state, extra={"preempted": False})
    RCheckpointManager(str(tmp_path / "ref")).save(
        7, rparams, rstate, extra={"preempted": False})
    a, b = tmp_path / "port" / "step_00000007", tmp_path / "ref" / \
        "step_00000007"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == \
        ["manifest.json", "opt.npz", "params.npz"]
    assert (a / "manifest.json").read_text() == \
        (b / "manifest.json").read_text()
    for name in ("params.npz", "opt.npz"):
        with np.load(a / name) as za, np.load(b / name) as zb:
            assert za.files == zb.files
            for k in zb.files:
                assert za[k].dtype == zb[k].dtype and \
                    za[k].shape == zb[k].shape, k
                np.testing.assert_array_equal(za[k], zb[k])
    # cross restores
    p2, o2, man = CheckpointManager(str(tmp_path / "ref")).restore(
        pm.abstract_params().to_empty(device="cpu"), init_opt_state(params))
    assert man == {"step": 7, "preempted": False}
    assert _worst(params_to_reference(p2), tree)[0] == 0
    assert int(o2["step"]) == 7 and all(
        torch.equal(o2["v"][k], state["v"][k]) for k in state["v"])
    rp, ro, _ = RCheckpointManager(str(tmp_path / "port")).restore(
        rparams, rstate)
    assert _worst(rp, tree)[0] == 0
    assert int(ro["step"]) == 7 and ro["step"].dtype == np.int32


def _restart_setup(tmp_dir, steps):
    cfg, ref_cfg = _configs("qwen3-1.7b", n_layers=2)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    port = (Model(cfg, device="cpu", remat=False),
            SyntheticTokens(DataConfig(**kw)),
            TrainConfig(steps=steps, checkpoint_every=3,
                        checkpoint_dir=str(tmp_dir), log_every=100,
                        opt=OptConfig(**opt)))
    ref = (RModel(ref_cfg, remat=False), RSyntheticTokens(RDataConfig(**kw)),
           RTrainConfig(steps=steps, checkpoint_every=3,
                        checkpoint_dir=str(tmp_dir), log_every=100,
                        opt=r_opt.OptConfig(**opt)))
    return port, ref


def _run(package, tmp_dir, steps):
    port, ref = _restart_setup(tmp_dir, steps)
    if package == "port":
        out = Trainer(*port).run(verbose=False)
        return params_to_reference(out["params"])
    out = RTrainer(*ref).run(verbose=False)
    return jax.tree.map(np.asarray, out["params"])


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_cross_package_restart(tmp_path, writer, reader):
    """``writer``'s Trainer takes qwen3-1.7b (reduced, 2 layers, float32)
    to step 3 and checkpoints; ``reader``'s Trainer resumes it to step 6.
    The result equals the writer's own resume to step 6 within
    ``TRAJECTORY_TOL`` per leaf."""
    _run(writer, tmp_path / "a", 3)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    own = _run(writer, tmp_path / "a", 6)
    other = _run(reader, tmp_path / "b", 6)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [3, 6]
    worst, leaf = _worst(other, own)
    assert worst <= TRAJECTORY_TOL, (leaf, worst)


def test_global_norm_is_every_leaf():
    g = {"a": torch.tensor([3.0]), "b": {"c": torch.tensor([4.0, 0.0])}}
    assert float(global_norm(g)) == 5.0
