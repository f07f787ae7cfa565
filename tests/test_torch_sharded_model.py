"""The port's sharded LM path (``Model(cfg, mesh=...)`` over DTensor,
``train`` on a mesh, ``launch/train.py --mesh``) on gloo ranks on the
CPU, against the reference package.

The oracle for a sharded model of any kind is the reference's unsharded
``Model`` run on each dp shard's rows alone: the logits concatenated, the
loss and ``aux`` averaged, the gradients of that mean (the MoE's capacity
and balance loss are per dp shard in the reference's expert-parallel
island; every other op is per token or per sequence).  The decode oracle
is the same per shard: its logits and cache leaves concatenated on the
batch axis.  One AdamW step is held against the port's unsharded
``adamw_update`` on the oracle's gradients (that update against the
reference's is ``test_torch_train.py``'s).  The reference's parameters
(seeded numpy trees of its structure, ``test_torch_lm_model
.reference_tree``) are carried into the sharded port by
``params_from_reference``.

Cases on four ranks: every block kind at (2, 2); the dense, MoE and
hybrid kinds at (4, 1) and (1, 4); context parallel on (1, 4) with six
heads (``reduced(n_heads=6, n_kv_heads=2)``: 6 % 4 != 0), also
``context_parallel_attention`` alone against the reference's
``blocked_attention``; a batch-1 decode at (2, 2), whose cache shards the
sequence over ``data``; the MoE at (2, 2) also against the reference's
*sharded* ``Model`` on four fake XLA devices (this file's ``__main__`` in
a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
checkpoints across (2, 2), the reference and the unsharded port;
``launch/train.py --mesh 2x2 --reduced``'s losses against the unsharded
launcher's.  On two ranks: (2, 1), data parallel only.

Bar: rel-L2 1e-5 in float32 for every logit, loss, aux, updated
parameter and cache leaf (``TOL``).  The launcher trains the reduced
config in its own dtype, bf16, where the tensor-parallel partial sums
round in another order than the unsharded products: its losses within
1e-3 relative (``LAUNCH_TOL``; measured 8.1e-5 at step 1).  Gradient leaves: 5e-5 (``GRAD_TOL``): measured worst 1.5e-5
(xlstm's ``units.0.mlstm.conv.w`` at (2, 2)), which is the float32 spread
between the two frameworks' summation orders, not the sharding: the
unsharded port's gradient of the same case shows 1.53e-5 against the same
oracle (``test_torch_train.py`` holds gradients at 1e-4).

The ranks are spawned processes (``torch.multiprocessing``) that import
no JAX: the reference is imported only inside the functions that run it.
Each rank runs one torch thread and joins its group through a
``file://`` store under the test's temporary directory.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

TOL = 1e-5
GRAD_TOL = 5e-5
LAUNCH_TOL = 1e-3
B, S, PROMPT, DECODES, MAXLEN = 4, 24, 20, 3, 32
#: one config a block kind, at the depth ``test_torch_lm_model`` runs it
KINDS = {"gqa": ("qwen3-1.7b", 2), "gemma": ("gemma3-27b", 6),
         "musicgen": ("musicgen-medium", 2),
         "gqa_moe": ("granite-moe-1b-a400m", 2),
         "mla_moe": ("deepseek-v2-lite-16b", 3),
         "vlm": ("llama-3.2-vision-90b", 5), "xlstm": ("xlstm-350m", 4),
         "hymba": ("hymba-1.5b", 4)}
#: (case, mesh, arch, depth, reduced() overrides)
CASES4 = [(f"2x2-{k}", (2, 2), a, n, {}) for k, (a, n) in KINDS.items()]
CASES4 += [(f"{m}-{k}", shape, *KINDS[k], {})
           for m, shape in (("4x1", (4, 1)), ("1x4", (1, 4)))
           for k in ("gqa", "gqa_moe", "hymba")]
CASES4 += [("1x4-cp", (1, 4), "starcoder2-7b", 2,
            {"n_heads": 6, "n_kv_heads": 2})]
CASES2 = [(f"2x1-{k}", (2, 1), *KINDS[k], {}) for k in ("gqa", "gqa_moe")]
#: the vlm's cross gate in the trees (the reference's init: 0)
CROSS_GATE = 0.7


def _seed(case: str) -> int:
    return sum(map(ord, case)) % 1000


def _port_cfg(arch: str, depth: int, over: dict):
    from repro_torch.configs import base
    return dataclasses.replace(
        base.get_config(arch).reduced(n_layers=depth, **over),
        dtype=torch.float32)


def _inputs(cfg, batch: int, seed: int) -> dict:
    """The seeded tokens (and image embeddings) both packages run."""
    rng = np.random.default_rng(seed)
    shape = (batch, S, cfg.n_codebooks) if cfg.n_codebooks else (batch, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.block_kind == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------
def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _load_tree(tmp: str, case: str) -> dict:
    from repro_torch.models.convert import _nest
    with np.load(os.path.join(tmp, f"tree_{case}.npz")) as z:
        return _nest({k: z[k] for k in z.files})


def _decode(model, params, ins, batch: int) -> tuple[list, dict]:
    tok = torch.from_numpy(ins["tokens"][:batch])
    img = ins.get("image_embeds")
    img = None if img is None else torch.from_numpy(img[:batch])
    with torch.no_grad():
        cache = model.init_cache(batch, MAXLEN)
        lg, cache = model.prefill(params, tok[:, :PROMPT], cache,
                                  image_embeds=img)
        logits = [lg]
        for t in range(DECODES):
            lg, cache = model.decode_step(params, tok[:, PROMPT + t:
                                                      PROMPT + t + 1],
                                          cache, PROMPT + t,
                                          image_embeds=img)
            logits.append(lg)
    return logits, cache


def _run_case(case, shape, arch, depth, over, tmp) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.trainer import value_and_grad

    cfg = _port_cfg(arch, depth, over)
    model = Model(cfg, mesh=make_mesh(shape, ("data", "model")),
                  device="cpu")
    params = params_from_reference(model, _load_tree(tmp, case))
    ins = _inputs(cfg, B, _seed(case))
    batch = {k: torch.from_numpy(v) for k, v in ins.items()}
    out = {}
    with torch.no_grad():
        logits, aux, _ = model.forward(params, batch["tokens"],
                                       image_embeds=batch.get("image_embeds"))
    out[f"{case}|logits"] = _full(logits)
    out[f"{case}|aux"] = _full(aux)
    (_, metrics), grads = value_and_grad(model, params, batch)
    out[f"{case}|loss"] = _full(metrics["loss"])
    for k, g in grads.items():
        out[f"{case}|grad|{k}"] = _full(g)
    steps, cache = _decode(model, params, ins, B)
    out[f"{case}|decode"] = np.concatenate([_full(x) for x in steps], 1)
    for k, v in _leaves(cache):
        out[f"{case}|cache|{k}"] = _full(v)
    opt = init_opt_state(params)
    adamw_update(OptConfig(), params, grads, opt)
    for k, p in params.named_parameters():
        out[f"{case}|step|{k}"] = _full(p)
    return out


def _extra_cases(tmp: str) -> dict:
    """Four ranks: the batch-1 decode, context-parallel attention alone,
    the checkpoints, the launcher."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A
    from repro_torch.models.convert import named_tensors, params_from_reference
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import Sharder
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state)

    out = {}
    mesh22 = make_mesh((2, 2), ("data", "model"))
    # a batch-1 decode: the cache's sequence axis sharded over data
    cfg = _port_cfg("qwen3-1.7b", 2, {})
    model = Model(cfg, mesh=mesh22, device="cpu")
    params = params_from_reference(model, _load_tree(tmp, "b1"))
    steps, cache = _decode(model, params, _inputs(cfg, 1, _seed("b1")), 1)
    out["b1|decode"] = np.concatenate([_full(x) for x in steps], 1)
    out["b1|cache_spec"] = np.array(str(cache["k"].placements))
    for k, v in _leaves(cache):
        out[f"b1|cache|{k}"] = _full(v)

    # context-parallel attention alone on (1, 4)
    with np.load(os.path.join(tmp, "cp_attn.npz")) as z:
        q, k, v = (torch.from_numpy(z[n]) for n in ("q", "k", "v"))
    sh = Sharder(make_mesh((1, 4), ("data", "model")), device="cpu")
    y = A.context_parallel_attention(q, k, v, sharder=sh, block_q=4,
                                     block_k=8)
    out["cp_attn|y"] = _full(y)

    # a checkpoint saved at (2, 2) after one AdamW step
    params = params_from_reference(model, _load_tree(tmp, "ckpt"))
    grads = {k: torch.full_like(p, 0.01) for k, p in
             named_tensors(params).items()}
    _, opt, _ = adamw_update(OptConfig(), params, grads,
                             init_opt_state(params))
    CheckpointManager(os.path.join(tmp, "ck_port")).save(
        1, params, opt, extra={"mesh": "2x2"})
    for k, p in named_tensors(params).items():
        out[f"ckpt|param|{k}"] = _full(p)
    # the reference's checkpoint restored at (2, 2)
    template = model.init_params(torch.Generator("cpu").manual_seed(1))
    restored, ropt, manifest = CheckpointManager(
        os.path.join(tmp, "ck_ref")).restore(template,
                                            init_opt_state(template))
    for k, p in named_tensors(restored).items():
        out[f"ck_ref|param|{k}"] = _full(p)
    for k, m in ropt["m"].items():
        out[f"ck_ref|m|{k}"] = _full(m)
    out["ck_ref|step"] = np.asarray(int(ropt["step"]))

    # the launcher on the four ranks
    losses = _record_losses(trainer_mod)
    rc = launch_train.main(_launch_argv(tmp, "launch4") +
                           ["--mesh", "2x2"])
    out["launch|rc"] = np.asarray(rc)
    out["launch|losses"] = np.asarray(losses, np.float64)
    dist.barrier()
    return out


def _launch_argv(tmp: str, name: str) -> list:
    return ["--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
            "--device", "cpu", "--checkpoint-every", "2",
            "--checkpoint-dir", os.path.join(tmp, name)]


def _record_losses(trainer_mod) -> list:
    """Every train step's loss from here on (``build_train_step``
    wrapped)."""
    losses: list = []
    build = trainer_mod.build_train_step

    def recording(*a, **kw):
        step = build(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            losses.append(float(out[2]["loss"]))
            return out
        return run
    trainer_mod.build_train_step = recording
    return losses


def _rank_main(rank: int, world: int, tmp: str, cases: list) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import exit_rank

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = {}
        for case in cases:
            out.update(_run_case(*case, tmp))
        if world == 4:
            out.update(_extra_cases(tmp))
        if rank == 0:
            np.savez(os.path.join(tmp, f"port{world}.npz"),
                     **{k.replace("/", "~"): v for k, v in out.items()})
    finally:
        dist.destroy_process_group()
    exit_rank()


# ---------------------------------------------------------------------------
# the reference (JAX: imported only here, in the test process or __main__)
# ---------------------------------------------------------------------------
def _ref_models(arch: str, depth: int, over: dict, mesh=None):
    import jax.numpy as jnp

    from repro.configs import base as r_base
    from repro.models.model import Model as RModel

    cfg = dataclasses.replace(
        r_base.get_config(arch).reduced(n_layers=depth, **over),
        dtype=jnp.float32)
    return RModel(cfg, mesh=mesh, remat=False)


def _ref_tree(rm, seed: int) -> dict:
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            value = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        else:
            value = rng.standard_normal(spec.shape) * spec.shape[-2] ** -0.5
        return value.astype(spec.dtype)

    shapes = jax.eval_shape(rm.init_params, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    if "units" in tree and "cross" in tree["units"]:
        gate = tree["units"]["cross"]["gate"]
        tree["units"]["cross"]["gate"] = np.full_like(gate, CROSS_GATE)
    return tree


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _oracle(rm, tree: dict, ins: dict, dp: int, decode: bool = True) -> dict:
    """The reference's unsharded model on each dp shard's rows: logits
    concatenated, loss and aux averaged, gradients of the mean; the
    decode's logits and cache concatenated on the batch axis."""
    import jax
    import jax.numpy as jnp

    from repro_torch.models.convert import flat_reference

    rows = ins["tokens"].shape[0] // dp

    @jax.jit
    def fwd(p, b):
        logits, aux, _ = rm.forward(p, b["tokens"],
                                    image_embeds=b.get("image_embeds"))
        (_, met), g = jax.value_and_grad(rm.loss_fn, has_aux=True)(p, b)
        return logits, aux, met["loss"], g

    prefill = jax.jit(lambda p, t, c, im: rm.prefill(p, t, c,
                                                     image_embeds=im))
    step = jax.jit(lambda p, t, c, pos, im: rm.decode_step(
        p, t, c, pos, image_embeds=im))
    out = {"logits": [], "aux": [], "loss": [], "grads": None,
           "decode": [], "cache": []}
    for i in range(dp):
        part = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                for k, v in ins.items()}
        logits, aux, loss, g = fwd(tree, part)
        out["logits"].append(np.asarray(logits))
        out["aux"].append(float(aux))
        out["loss"].append(float(loss))
        g = {k: np.asarray(v, np.float64) / dp
             for k, v in flat_reference(jax.tree.map(np.asarray, g)).items()}
        out["grads"] = g if out["grads"] is None else \
            {k: out["grads"][k] + v for k, v in g.items()}
        if not decode:
            continue
        img = part.get("image_embeds")
        cache = rm.init_cache(rows, MAXLEN)
        lg, cache = prefill(tree, part["tokens"][:, :PROMPT], cache, img)
        steps = [np.asarray(lg)]
        for t in range(DECODES):
            lg, cache = step(tree, part["tokens"][:, PROMPT + t:
                                                   PROMPT + t + 1],
                             cache, PROMPT + t, img)
            steps.append(np.asarray(lg))
        out["decode"].append(np.concatenate(steps, 1))
        out["cache"].append({k: np.asarray(v, np.float32)
                             for k, v in _leaves(jax.tree.map(np.asarray,
                                                              cache))})
    res = {"logits": np.concatenate(out["logits"]),
           "aux": float(np.mean(out["aux"])),
           "loss": float(np.mean(out["loss"])), "grads": out["grads"]}
    if decode:
        res["decode"] = np.concatenate(out["decode"])
        res["cache"] = out["cache"]
    return res


def _adamw_oracle(cfg, tree: dict, grads: dict) -> dict:
    """The port's unsharded AdamW step on the oracle's gradients."""
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state)

    model = Model(cfg, device="cpu")
    params = params_from_reference(model, tree)
    g = {k: torch.from_numpy(v.astype(np.float32)) for k, v in grads.items()}
    adamw_update(OptConfig(), params, g, init_opt_state(params))
    return {k: p.detach().numpy() for k, p in params.named_parameters()}


def _reference_sharded_moe(tmp: str) -> None:
    """This file's ``__main__``: the reference's sharded granite at (2, 2)
    on four fake devices: logits, aux, loss, gradients."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_mesh
    from repro.models.sharding import param_specs
    from repro_torch.models.convert import flat_reference

    case = "2x2-gqa_moe"
    arch, depth = KINDS["gqa_moe"]
    mesh = make_mesh((2, 2), ("data", "model"))
    rm = _ref_models(arch, depth, {}, mesh=mesh)
    tree = _ref_tree(_ref_models(arch, depth, {}), _seed(case))
    specs = param_specs(tree, mesh)
    tree = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh,
                                                                      s)),
                        tree, specs, is_leaf=lambda x: isinstance(x, P))
    ins = _inputs(rm.cfg, B, _seed(case))
    tokens = jax.device_put(ins["tokens"],
                            NamedSharding(mesh, P("data", None)))

    @jax.jit
    def fwd(p, t):
        logits, aux, _ = rm.forward(p, t)
        (_, met), g = jax.value_and_grad(rm.loss_fn, has_aux=True)(
            p, {"tokens": t})
        return logits, aux, met["loss"], g

    with mesh:
        logits, aux, loss, g = fwd(tree, tokens)
    out = {"logits": np.asarray(logits), "aux": np.asarray(aux),
           "loss": np.asarray(loss)}
    out.update({f"grad|{k}": np.asarray(v) for k, v in
                flat_reference(jax.tree.map(np.asarray, g)).items()})
    np.savez(os.path.join(tmp, "ref_sharded_moe.npz"), **out)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _load(path: str) -> dict:
    with np.load(path) as z:
        return {k.replace("~", "/"): z[k] for k in z.files}


def _write_trees(tmp: str, cases) -> dict:
    """The reference's models and trees of every case, each tree saved
    for the ranks."""
    out = {}
    for case, _, arch, depth, over in cases:
        rm = _ref_models(arch, depth, over)
        tree = _ref_tree(rm, _seed(case))
        np.savez(os.path.join(tmp, f"tree_{case}.npz"), **_flat_tree(tree))
        out[case] = (rm, tree)
    return out


def _spawn(world: int, tmp: str, cases: list):
    import torch.multiprocessing as mp
    return mp.start_processes(_rank_main, args=(world, tmp, cases),
                              nprocs=world, join=False,
                              start_method="spawn")


def _join(ctx) -> None:
    while not ctx.join():
        pass


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.models.attention import blocked_attention as r_blocked
    from repro.train import optimizer as r_opt
    from repro.train.checkpoint import CheckpointManager as RCkpt

    jax.config.update("jax_enable_x64", True)
    tmp = str(tmp_path_factory.mktemp("sharded4"))
    extra = [("b1", None, "qwen3-1.7b", 2, {}),
             ("ckpt", None, "qwen3-1.7b", 2, {})]
    models = _write_trees(tmp, CASES4 + extra)
    rng = np.random.default_rng(7)
    cp = {"q": rng.standard_normal((2, 22, 6, 16)).astype(np.float32),
          "k": rng.standard_normal((2, 22, 2, 16)).astype(np.float32),
          "v": rng.standard_normal((2, 22, 2, 16)).astype(np.float32)}
    np.savez(os.path.join(tmp, "cp_attn.npz"), **cp)
    # the reference's checkpoint, for the ranks to restore at (2, 2)
    rm, tree = models["ckpt"]
    ref_opt = r_opt.init_opt_state(tree)
    ref_opt = {"m": jax.tree.map(lambda a: np.full(a.shape, 0.25,
                                                   np.float32), ref_opt["m"]),
               "v": ref_opt["v"], "step": jnp.asarray(5, jnp.int32)}
    RCkpt(os.path.join(tmp, "ck_ref")).save(5, tree, ref_opt)

    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__), tmp],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    ctx = _spawn(4, tmp, CASES4)
    try:
        oracles = {}
        for case, shape, arch, depth, over in CASES4:
            rm, tree = models[case]
            oracles[case] = _oracle(rm, tree, _inputs(rm.cfg, B,
                                                      _seed(case)),
                                    shape[0])
            oracles[case]["step"] = _adamw_oracle(
                _port_cfg(arch, depth, over), tree, oracles[case]["grads"])
        rm, tree = models["b1"]
        oracles["b1"] = _oracle(rm, tree, _inputs(rm.cfg, 1, _seed("b1")),
                                1)
        oracles["cp_attn"] = np.asarray(r_blocked(
            *(jnp.asarray(cp[n]) for n in ("q", "k", "v")), causal=True,
            block_q=4, block_k=8))
        # the unsharded launcher's losses
        from repro_torch.launch import train as launch_train
        from repro_torch.train import trainer as trainer_mod
        build = trainer_mod.build_train_step
        try:
            losses = _record_losses(trainer_mod)
            launch_train.main(_launch_argv(tmp, "launch1"))
        finally:
            trainer_mod.build_train_step = build
        oracles["launch"] = losses
    finally:
        _join(ctx)
        log, _ = ref.communicate(timeout=600)
    return {"port": _load(os.path.join(tmp, "port4.npz")),
            "oracle": oracles, "models": models, "tmp": tmp,
            "reference_sharded": (ref.returncode, log)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded2"))
    models = _write_trees(tmp, CASES2)
    ctx = _spawn(2, tmp, CASES2)
    try:
        oracles = {}
        for case, shape, arch, depth, over in CASES2:
            rm, tree = models[case]
            oracles[case] = _oracle(rm, tree, _inputs(rm.cfg, B,
                                                      _seed(case)),
                                    shape[0])
            oracles[case]["step"] = _adamw_oracle(
                _port_cfg(arch, depth, over), tree, oracles[case]["grads"])
    finally:
        _join(ctx)
    return {"port": _load(os.path.join(tmp, "port2.npz")),
            "oracle": oracles}


def _ranks(request, case: str):
    return request.getfixturevalue("two_ranks" if case.startswith("2x1")
                                   else "four_ranks")


ALL = [c[0] for c in CASES4 + CASES2]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ALL)
def test_sharded_forward_is_the_oracle(request, case):
    r = _ranks(request, case)
    port, want = r["port"], r["oracle"][case]
    assert _rel(port[f"{case}|logits"], want["logits"]) <= TOL
    assert abs(float(port[f"{case}|loss"]) - want["loss"]) <= \
        TOL * max(abs(want["loss"]), 1.0)
    assert abs(float(port[f"{case}|aux"]) - want["aux"]) <= \
        TOL * max(abs(want["aux"]), 1.0)


@pytest.mark.parametrize("case", ALL)
def test_sharded_gradients_are_the_oracle(request, case):
    r = _ranks(request, case)
    port, want = r["port"], r["oracle"][case]["grads"]
    names = [k.split("|", 2)[2] for k in port if k.startswith(f"{case}|grad|")]
    assert sorted(names) == sorted(want)
    worst = max((_rel(port[f"{case}|grad|{k}"], want[k]), k) for k in names)
    assert worst[0] <= GRAD_TOL, worst


@pytest.mark.parametrize("case", ALL)
def test_sharded_adamw_step_is_the_oracle(request, case):
    r = _ranks(request, case)
    port, want = r["port"], r["oracle"][case]["step"]
    worst = max((_rel(port[f"{case}|step|{k}"], v), k)
                for k, v in want.items())
    assert worst[0] <= TOL, worst


@pytest.mark.parametrize("case", ALL)
def test_sharded_decode_is_the_oracle(request, case):
    r = _ranks(request, case)
    port, want = r["port"], r["oracle"][case]
    assert _rel(port[f"{case}|decode"], want["decode"]) <= TOL
    axis = 2 if "vlm" in case else 1
    for k in want["cache"][0]:
        ref = np.concatenate([c[k] for c in want["cache"]], axis)
        got = port[f"{case}|cache|{k}"]
        assert got.shape == ref.shape, k
        if np.linalg.norm(ref):
            assert _rel(got, ref) <= TOL, k
        else:
            assert not np.abs(got).max(), k


def test_batch_one_decode_shards_the_cache_sequence(four_ranks):
    port, want = four_ranks["port"], four_ranks["oracle"]["b1"]
    # batch 1 does not divide over data: the sequence takes it
    assert "Shard(dim=2)" in str(port["b1|cache_spec"])
    assert _rel(port["b1|decode"], want["decode"]) <= TOL
    for k, ref in want["cache"][0].items():
        assert _rel(port[f"b1|cache|{k}"], ref) <= TOL, k


def test_context_parallel_attention_is_the_references(four_ranks):
    assert _rel(four_ranks["port"]["cp_attn|y"],
                four_ranks["oracle"]["cp_attn"]) <= TOL


def test_moe_at_2x2_is_the_references_sharded_model(four_ranks):
    rc, log = four_ranks["reference_sharded"]
    assert rc == 0, log[-3000:]
    ref = _load(os.path.join(four_ranks["tmp"], "ref_sharded_moe.npz"))
    port, case = four_ranks["port"], "2x2-gqa_moe"
    assert _rel(port[f"{case}|logits"], ref["logits"]) <= TOL
    assert abs(float(port[f"{case}|aux"]) - float(ref["aux"])) <= TOL
    assert abs(float(port[f"{case}|loss"]) - float(ref["loss"])) <= \
        TOL * max(abs(float(ref["loss"])), 1.0)
    worst = max((_rel(port[f"{case}|grad|{k[5:]}"], v), k)
                for k, v in ref.items() if k.startswith("grad|"))
    assert worst[0] <= GRAD_TOL, worst


def test_checkpoint_from_2x2_restores_in_the_reference_and_unsharded(
        four_ranks):
    import jax

    from repro.train import optimizer as r_opt
    from repro.train.checkpoint import CheckpointManager as RCkpt
    from repro_torch.models.convert import flat_reference
    from repro_torch.models.model import Model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import init_opt_state

    port, tmp = four_ranks["port"], four_ranks["tmp"]
    rm, tree = four_ranks["models"]["ckpt"]
    params, opt, manifest = RCkpt(os.path.join(tmp, "ck_port")).restore(
        jax.tree.map(np.zeros_like, tree),
        r_opt.init_opt_state(jax.tree.map(np.zeros_like, tree)))
    assert manifest["step"] == 1 and manifest["mesh"] == "2x2"
    flat = flat_reference(jax.tree.map(np.asarray, params))
    for k, v in flat.items():
        assert np.array_equal(v, port[f"ckpt|param|{k}"]), k
    assert int(opt["step"]) == 1
    model = Model(_port_cfg("qwen3-1.7b", 2, {}), device="cpu")
    template = model.init_params(torch.Generator("cpu").manual_seed(1))
    restored, ropt, _ = CheckpointManager(os.path.join(tmp, "ck_port")
                                          ).restore(template,
                                                    init_opt_state(template))
    for k, p in restored.named_parameters():
        assert np.array_equal(p.detach().numpy(), port[f"ckpt|param|{k}"]), k
    assert int(ropt["step"]) == 1


def test_reference_checkpoint_restores_at_2x2(four_ranks):
    from repro_torch.models.convert import flat_reference

    port = four_ranks["port"]
    _, tree = four_ranks["models"]["ckpt"]
    for k, v in flat_reference(tree).items():
        assert np.array_equal(port[f"ck_ref|param|{k}"], v), k
        assert np.all(port[f"ck_ref|m|{k}"] == 0.25), k
    assert int(port["ck_ref|step"]) == 5


def test_launch_train_mesh_2x2_matches_unsharded(four_ranks):
    port, want = four_ranks["port"], four_ranks["oracle"]["launch"]
    assert int(port["launch|rc"]) == 0
    got = [float(x) for x in port["launch|losses"]]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= LAUNCH_TOL * abs(w), (got, want)


if __name__ == "__main__":
    # the reference's sharded MoE on four fake XLA devices (XLA_FLAGS set
    # by the caller)
    import jax

    jax.config.update("jax_enable_x64", True)
    _reference_sharded_moe(sys.argv[1])
