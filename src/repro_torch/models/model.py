"""The decoder: the reference package's ``models/model.py`` on one device,
for every block kind: the flat stacks (``gqa``, ``gemma``, ``musicgen``,
``gqa_moe``, ``hymba``: attention and mamba in parallel), ``mla_moe``
(MLA over dense layers, then over MoE layers with shared experts), ``vlm``
(units of self layers and a gated cross layer over image tokens) and
``xlstm`` (units of an mLSTM and an sLSTM block).

The reference scans one block body over stacked layer parameters; here
each stack is a loop over per-layer modules (``Params.layers``,
``dense_layers``, ``units``), with the per-layer flags (gemma's and
hymba's local/global pattern) as Python booleans.  The cache keeps the
reference's nested layout (``_cache_layout``: per stack a leading layer
axis, then the batch; KV ``(L, B, Smax, KH, D)``, MLA's latent ``c_kv`` and
``k_rope``, the recurrent states in float32), and is written in place, in
its own dtypes.

Parameters are an ``nn.Module`` tree (``Params``) whose state-dict names
are the reference's parameter paths with the layer index spliced in
(``layers.3.attn.wq.w``, ``units.1.self.0.mlp.up.w``).  They are created
by ``init_params`` from a ``torch.Generator`` on the model's device, or
carried over from the reference by ``models/convert.py``.  They stay
float32, cast to the compute dtype at use as in the reference;
``cast_params`` casts them once instead (serving does), which gives the
same numbers.

Training (``loss_fn``) differentiates the no-cache forward with autograd.
With ``remat`` each layer of a flat stack, each vlm unit and each xlstm
unit runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps
only the body's input and recomputes the rest in the backward: the
reference's ``jax.checkpoint`` with the ``nothing_saveable`` policy.  It
applies only where autograd records (grad enabled) and there is no cache.

On a mesh (``Model(cfg, mesh=...)``, a ``launch.mesh.Mesh`` over the
ranks of the default process group) every parameter is a DTensor laid out
by ``sharding.param_specs`` and the activations are DTensors whose layout
``self.sh`` (a ``Sharder``) constrains where the reference does: the
batch over dp after the embedding and after each block, the sequence over
tp too in training (the SP residual; off with a cache), the logits'
vocabulary over tp.  Two parts run as islands on local tensors, as the
reference's ``shard_map``s: the MoE (experts over ``model``, their tables
gathered over ``data`` after the cast to the compute dtype, offset
``rank_in_model * E / tp``) and context-parallel attention where the heads
do not divide over tp (``_cp_mesh``).  The cache is placed by
``kv_cache_spec`` and written in each rank's local piece.  A sharded
model draws the same numbers as an unsharded one from the same generator:
every rank draws every full tensor and keeps its slice.
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from types import SimpleNamespace

from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S
from .sharding import (Sharder, all_reduce_nograd, distribute, is_dtensor,
                       island, leave, like, param_specs, pmean, psum)

KINDS = ("gqa", "gemma", "musicgen", "gqa_moe", "mla_moe", "vlm", "xlstm",
         "hymba")
#: the kinds whose layers form one flat stack
FLAT_KINDS = ("gqa", "gemma", "musicgen", "gqa_moe", "hymba")

#: parameters the reference casts to the activation dtype at use: dense
#: weights (MLA's latent maps, the conv taps), embedding tables, the
#: expert tables and the meta tokens
_CAST_AT_USE_NAMES = re.compile(
    r"\.w$|\.table$|\.moe\.(up|gate|down)$|^meta_tokens$")
#: the ``.w`` weights the reference multiplies in float32 (the router, the
#: recurrences' input, gate and dt projections)
_FLOAT32_NAMES = re.compile(
    r"(\.router|\.slstm\.wx|\.slstm\.rh|\.mlstm\.wif|\.mamba\.w_dt)\.w$")


class Block(L.Node):
    """One layer or unit's parameters."""


class Params(L.Node):
    """The model's parameters: ``embed``, ``final_norm``, the stacks (an
    ``nn.ModuleList`` each), and ``lm_head`` / ``meta_tokens`` where the
    config has them."""


def _cast_at_use(name: str) -> bool:
    """Whether the reference casts the parameter at this state-dict name to
    the activation dtype where it uses it."""
    return bool(_CAST_AT_USE_NAMES.search(name)) and \
        not _FLOAT32_NAMES.search(name)


def _map(fn, tree: dict) -> dict:
    """The nested dict with ``fn`` applied to every leaf."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _at(tree: dict, *index) -> dict:
    """Every leaf of a nested cache indexed by ``index`` (views)."""
    return _map(lambda t: t[index], tree)


def _copy_into(view: torch.Tensor, new: torch.Tensor) -> None:
    """``view.copy_(new)``; a DTensor view is written in its local piece,
    ``new`` laid out like it first."""
    if is_dtensor(view):
        src = new.redistribute(view.device_mesh, view.placements)
        view.to_local().copy_(src.to_local())
    else:
        view.copy_(new)


def _store(views: dict, new: dict) -> None:
    """Write each new state into its cache view, in the view's dtype."""
    for name, view in views.items():
        if isinstance(view, dict):
            _store(view, new[name])
        else:
            _copy_into(view, new[name])


def _maybe_remat(on: bool, body, *args):
    """``body(*args)``, under activation checkpointing where ``on``."""
    if not on:
        return body(*args)
    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False)


class Model:
    def __init__(self, cfg: ArchConfig, mesh=None,
                 device: str | torch.device | None = None,
                 remat: bool = True):
        if cfg.block_kind not in KINDS:
            raise ValueError(f"unknown block_kind {cfg.block_kind}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device("cuda:0" if device is None else device)
        # as the reference: a model of two layers or fewer never remats
        self.remat = remat and cfg.n_layers > 2
        self.sh = Sharder(mesh, device=self.device)

    # --------------------------- init ------------------------------------
    def init_params(self, gen: torch.Generator) -> Params:
        """Random float32 parameters drawn from ``gen``, which lives on the
        model's device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return self.shard(self._build(gen))

    def shard(self, params: Params) -> Params:
        """``params`` (the same full tensors on every rank) as DTensors
        laid out by ``param_specs``, each rank keeping its slice; the
        identity without a mesh."""
        if self.mesh is None:
            return params
        specs = param_specs(params, self.mesh)
        state = {k: distribute(v.detach(), specs[k], self.sh)
                 for k, v in params.state_dict().items()}
        shell = self._shell()
        shell.load_state_dict(state, assign=True)
        return shell

    def _shell(self) -> Params:
        """The parameter tree on the ``meta`` device: names and shapes."""
        return self._build(None)

    def _build(self, gen) -> Params:
        cfg = self.cfg
        if cfg.n_codebooks:
            embed = L.Embedding(torch.stack(
                [L.init_embedding(gen, cfg.vocab_size, cfg.d_model).table
                 for _ in range(cfg.n_codebooks)]))      # (nq, V, d)
        else:
            embed = L.init_embedding(gen, cfg.vocab_size, cfg.d_model)
        parts = {"embed": embed,
                 "final_norm": L.init_rmsnorm(cfg.d_model, gen)}
        if not cfg.tie_embeddings:
            if cfg.n_codebooks:
                parts["lm_head"] = L.Embedding(torch.stack(
                    [L.init_embedding(gen, cfg.vocab_size, cfg.d_model).table
                     for _ in range(cfg.n_codebooks)]))
            else:
                parts["lm_head"] = L.init_embedding(gen, cfg.vocab_size,
                                                    cfg.d_model)
        if cfg.n_meta_tokens:
            parts["meta_tokens"] = L._init(gen, (cfg.n_meta_tokens,
                                                 cfg.d_model), scale=0.02)
        parts.update(self._init_stacks(gen))
        return Params(**parts)

    def _init_stacks(self, gen) -> dict:
        cfg = self.cfg
        kind = cfg.block_kind
        d = cfg.d_model

        def stack(n, one):
            return nn.ModuleList([one() for _ in range(n)])

        def attn():
            return A.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.qk_norm)

        def norm():
            return L.init_rmsnorm(d, gen)

        if kind in ("gqa", "gemma", "musicgen"):
            return {"layers": stack(cfg.n_layers, lambda: Block(
                ln1=norm(), attn=attn(), ln2=norm(),
                mlp=L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_gated)))}
        if kind == "gqa_moe":
            return {"layers": stack(cfg.n_layers, lambda: Block(
                ln1=norm(), attn=attn(), ln2=norm(),
                moe=M.init_moe(gen, d, cfg.d_ff_expert, cfg.n_experts,
                               cfg.n_shared_experts)))}
        if kind == "mla_moe":
            def mla():
                return A.init_mla(gen, d, cfg.n_heads,
                                  kv_lora=cfg.kv_lora_rank,
                                  nope_dim=cfg.qk_nope_dim,
                                  rope_dim=cfg.qk_rope_dim,
                                  v_dim=cfg.v_head_dim)
            nd = cfg.first_dense_layers
            return {
                "dense_layers": stack(nd, lambda: Block(
                    ln1=norm(), attn=mla(), ln2=norm(),
                    mlp=L.init_mlp(gen, d, cfg.d_ff_dense, True))),
                "layers": stack(cfg.n_layers - nd, lambda: Block(
                    ln1=norm(), attn=mla(), ln2=norm(),
                    moe=M.init_moe(gen, d, cfg.d_ff_expert, cfg.n_experts,
                                   cfg.n_shared_experts,
                                   d_ff_shared=cfg.d_ff_expert
                                   * max(cfg.n_shared_experts, 1))))}
        if kind == "vlm":
            n_units, n_self = self._vlm_units()

            def unit():
                selfs = stack(n_self, lambda: Block(
                    ln1=norm(), attn=A.init_attention(
                        gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                    ln2=norm(), mlp=L.init_mlp(gen, d, cfg.d_ff, True)))
                cross = Block(
                    ln1=norm(), attn=A.init_cross_attention(
                        gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                    gate=torch.zeros((1,), dtype=torch.float32,
                                     device=L._device(gen)),
                    ln2=norm(), mlp=L.init_mlp(gen, d, cfg.d_ff, True))
                return Block(self=selfs, cross=cross)
            return {"units": stack(n_units, unit)}
        if kind == "xlstm":
            return {"units": stack(cfg.n_layers // 2, lambda: Block(
                m_ln=norm(),
                mlstm=S.init_mlstm(gen, d, cfg.n_heads,
                                   conv_k=cfg.conv_kernel),
                s_ln=norm(), slstm=S.init_slstm(gen, d, cfg.n_heads)))}
        # hymba
        return {"layers": stack(cfg.n_layers, lambda: Block(
            ln1=norm(),
            attn=A.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim),
            mamba=S.init_mamba(gen, d, cfg.d_inner, cfg.ssm_state,
                               cfg.conv_kernel),
            mix_norm_a=norm(), mix_norm_m=norm(), ln2=norm(),
            mlp=L.init_mlp(gen, d, cfg.d_ff, True)))}

    def _vlm_units(self) -> tuple[int, int]:
        """(units, self layers a unit): every ``cross_every``-th layer is
        a cross layer."""
        per = self.cfg.cross_every
        return self.cfg.n_layers // per, per - 1

    def cast_params(self, params: Params, dtype=None) -> Params:
        """The parameters with every weight the reference casts at use cast
        once to ``dtype`` (the config's compute dtype by default); norm
        scales, the router, the recurrences' float32 projections, biases
        and gates stay float32, as the reference reads them.  Uncast
        tensors are shared with ``params``."""
        dtype = self.cfg.dtype if dtype is None else dtype
        state = params.state_dict()
        if all(v.dtype == dtype for k, v in state.items() if _cast_at_use(k)):
            return params
        cast = {k: v.to(dtype) if _cast_at_use(k) else v
                for k, v in state.items()}
        shell = self._shell()
        shell.load_state_dict(cast, assign=True)
        return shell

    # --------------------------- flags ------------------------------------
    def _layer_flags(self) -> list[bool] | None:
        """Per-layer is_global booleans: gemma's every ``global_every``-th
        layer; hymba's first, middle and last layers."""
        cfg = self.cfg
        n = cfg.n_layers
        if cfg.block_kind == "gemma":
            return [i % cfg.global_every == cfg.global_every - 1
                    for i in range(n)]
        if cfg.block_kind == "hymba":
            return [i in (0, n // 2, n - 1) for i in range(n)]
        return None

    # --------------------------- embed/unembed ----------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.n_codebooks:
            tables = params.embed.table.to(cfg.dtype)  # (nq, V, d)
            return sum(L.embed(SimpleNamespace(table=tables[q]),
                               tokens[..., q], cfg.dtype,
                               sharder=self._sharder)
                       for q in range(cfg.n_codebooks))
        return L.embed(params.embed, tokens, cfg.dtype,
                       sharder=self._sharder)

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = getattr(params, "lm_head", params.embed)
        if self.cfg.n_codebooks:
            tables = head.table.to(x.dtype)  # (nq, V, d)
            return torch.einsum("bsd,qvd->bsqv", x, tables)
        return L.unembed(head, x)

    # --------------------------- blocks ------------------------------------
    @property
    def _sharder(self):
        """The sharder the layers take: the model's on a mesh, else
        None."""
        return self.sh if self.mesh is not None else None

    def _attn_block(self, p: Block, x, *, positions, is_global=None,
                    cache=None, kv_len=None):
        cfg = self.cfg
        h = L.rms_norm(p.ln1, x)
        if isinstance(p.attn, A.MLA):
            y, _ = A.mla_attention(
                p.attn, h, n_heads=cfg.n_heads, kv_lora=cfg.kv_lora_rank,
                nope_dim=cfg.qk_nope_dim, rope_dim=cfg.qk_rope_dim,
                v_dim=cfg.v_head_dim, positions=positions,
                rope_theta=cfg.rope_theta, cache=cache, kv_len=kv_len,
                sharder=self._sharder)
        else:
            y, _ = A.attention(
                p.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, positions=positions,
                rope_theta=cfg.rope_theta, window=cfg.window,
                is_global=is_global, qk_norm=cfg.qk_norm, cache=cache,
                kv_len=kv_len, cp_mesh=self._cp_mesh(),
                sharder=self._sharder)
        return self._residual(x, y)

    def _residual(self, x, y):
        """``x + y`` on the residual stream, constrained by ``sh.acts``.
        On a mesh ``y`` (a row-parallel product's partial sum, an island's
        output) is laid out as ``x`` first, explicitly: the SP
        reduce-scatter, and in the backward both terms' gradients in
        ``x``'s layout."""
        if is_dtensor(x) and is_dtensor(y) and y.placements != x.placements:
            y = y.redistribute(x.device_mesh, x.placements)
        return self.sh.acts(x + y)

    def _cp_mesh(self):
        """The mesh, for context-parallel attention, where head-TP is
        impossible (``n_heads % tp != 0``); else None."""
        if self.mesh is None:
            return None
        if self.cfg.n_heads % self.mesh.shape[self.sh.tp] == 0:
            return None
        return self.mesh

    def _ffn_block(self, p: Block, x):
        cfg = self.cfg
        if hasattr(p, "moe"):
            y, aux = self._moe(p.moe, L.rms_norm(p.ln2, x))
        else:
            y, aux = L.mlp(p.mlp, L.rms_norm(p.ln2, x), gated=cfg.mlp_gated,
                           act=cfg.mlp_act), 0.0
        return self._residual(x, y), aux

    def _moe(self, p, x):
        """The MoE; on a mesh the reference's expert-parallel island."""
        cfg, sh = self.cfg, self.sh
        if self.mesh is None:
            return M.moe_ffn(p, x, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        dp = sh.dp if x.shape[0] % sh.dp_size == 0 and x.shape[0] > 1 \
            else None
        xspec = (dp, None, None)
        cd = x.dtype
        # the expert tables cast to the compute dtype BEFORE their gather
        # over data: the gather moves half the bytes
        args = [x, p.router.w, p.up.to(cd), p.gate.to(cd), p.down.to(cd)]
        specs = [xspec, (None, None), ("model", None, None),
                 ("model", None, None), ("model", None, None)]
        if hasattr(p, "shared"):
            args += [p.shared.up.w, p.shared.gate.w, p.shared.down.w]
            specs += [(None, "model"), (None, "model"), ("model", None)]
        e_total = cfg.n_experts
        off = sh.index("model") * (e_total // sh.tp_size)

        def body(xx, router, up, gate, down, *sw):
            w = SimpleNamespace(router=SimpleNamespace(w=router), up=up,
                                gate=gate, down=down)
            if sw:
                w.shared = SimpleNamespace(
                    up=SimpleNamespace(w=sw[0]), gate=SimpleNamespace(w=sw[1]),
                    down=SimpleNamespace(w=sw[2]))
            y, aux = M.moe_ffn(w, xx, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               ep_axis=sh.group("model"), expert_offset=off,
                               n_experts_total=e_total)
            if dp is not None:
                for a in dp:
                    aux = pmean(aux, sh.group(a), self.mesh.shape[a])
            return y, aux
        return island(sh, body, args, specs, (xspec, ()))

    # --------------------------- forward (train/prefill) -------------------
    def forward(self, params: Params, tokens: torch.Tensor, *,
                image_embeds=None, cache=None, kv_len=None,
                last_token_only: bool = False):
        """Returns (logits, aux_loss, new_cache).  cache None: no caching
        (training).  A prefill passes an empty cache and kv_len=0;
        last_token_only skips the (B, S, V) logits (a prefill only needs
        the last position).  The meta tokens (hymba) are prepended where
        the sequence starts: with no cache, or at kv_len 0."""
        cfg = self.cfg
        sh = self.sh
        # the SP residual only where its memory matters (training)
        sh.sp = cache is None
        if self.mesh is not None:
            tokens = sh.batch(tokens)
            if image_embeds is not None:
                image_embeds = sh.batch(image_embeds)
        x = self._embed(params, tokens)
        b = x.shape[0]
        n_meta = 0
        if cfg.n_meta_tokens and (cache is None or kv_len == 0):
            meta = params.meta_tokens.to(x.dtype).expand(
                b, cfg.n_meta_tokens, x.shape[-1])
            x = torch.cat([meta, x], dim=1)
            n_meta = cfg.n_meta_tokens
        x = sh.acts(x)
        steps = torch.arange(x.shape[1], device=x.device)
        positions = steps if kv_len is None else kv_len + steps
        aux_total = self._zero(x)

        kind = cfg.block_kind
        if kind in FLAT_KINDS:
            x, aux_total = self._run_flat_stack(params.layers, x, positions,
                                                self._layer_flags(), cache,
                                                kv_len)
        elif kind == "mla_moe":
            x, aux0 = self._run_flat_stack(
                params.dense_layers, x, positions, None,
                cache["dense"] if cache is not None else None, kv_len)
            x, aux1 = self._run_flat_stack(
                params.layers, x, positions, None,
                cache["moe"] if cache is not None else None, kv_len)
            aux_total = aux0 + aux1
        elif kind == "vlm":
            if image_embeds is None:
                raise ValueError("block kind 'vlm' needs image_embeds (B, "
                                 "n_image_tokens, d_model)")
            x = self._run_vlm(params.units, x, positions, image_embeds,
                              cache, kv_len)
        else:  # xlstm
            x = self._run_xlstm(params.units, x, cache)

        x = L.rms_norm(params.final_norm, x)
        if n_meta:
            x = x[:, n_meta:]
        if last_token_only:
            x = x[:, -1:]
        return sh.logits(self._unembed(params, x)), aux_total, cache

    @staticmethod
    def _zero(x):
        """A float32 zero beside x (a replicated DTensor on a mesh)."""
        return like(torch.zeros((), dtype=torch.float32, device=x.device), x)

    # ------------------ flat homogeneous stacks ----------------------------
    def _remat_on(self, cache) -> bool:
        return self.remat and cache is None and torch.is_grad_enabled()

    def _run_flat_stack(self, layers, x, positions, flags, cache, kv_len):
        aux_total = self._zero(x)
        remat = self._remat_on(cache)
        for i, p in enumerate(layers):
            c_in = _at(cache, i) if cache is not None else None
            flag = flags[i] if flags else None

            def body(x, p=p, c_in=c_in, flag=flag):
                if hasattr(p, "mamba"):
                    x = self._hymba_mix(p, x, positions, flag, c_in, kv_len)
                else:
                    x = self._attn_block(p, x, positions=positions,
                                         is_global=flag, cache=c_in,
                                         kv_len=kv_len)
                return self._ffn_block(p, x)
            x, aux = _maybe_remat(remat, body, x)
            aux_total = aux_total + aux
        return x, aux_total

    def _hymba_mix(self, p: Block, x, positions, flag, cache, kv_len):
        """Hymba's mixer: attention and mamba in parallel on one norm of
        x, fused by the mean of their own norms."""
        cfg = self.cfg
        h = L.rms_norm(p.ln1, x)
        m_conv = m_ssm = None
        if cache is not None:
            m_conv, m_ssm = cache["conv"], cache["ssm"]
        ya, _ = A.attention(p.attn, h, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                            positions=positions, rope_theta=cfg.rope_theta,
                            window=cfg.window, is_global=flag,
                            cache=cache, kv_len=kv_len,
                            cp_mesh=self._cp_mesh(), sharder=self._sharder)
        ym, (new_conv, new_ssm) = S.mamba_mix(p.mamba, h, m_conv, m_ssm,
                                              sharder=self._sharder)
        if cache is not None:
            _copy_into(m_conv, new_conv)
            _copy_into(m_ssm, new_ssm)
        y = 0.5 * (L.rms_norm(p.mix_norm_a, ya)
                   + L.rms_norm(p.mix_norm_m, ym))
        return self._residual(x, y)

    # ------------------------------ vlm ------------------------------------
    def _run_vlm(self, units, x, positions, image_embeds, cache, kv_len):
        cfg = self.cfg
        remat = self._remat_on(cache)
        for u, unit in enumerate(units):
            def body(x, u=u, unit=unit):
                for i, sp in enumerate(unit.self):
                    c_in = _at(cache["self"], u, i) if cache is not None \
                        else None
                    x = self._attn_block(sp, x, positions=positions,
                                         cache=c_in, kv_len=kv_len)
                    x, _ = self._ffn_block(sp, x)
                cp = unit.cross
                h = L.rms_norm(cp.ln1, x)
                y = A.cross_attention(cp.attn, h, image_embeds,
                                      n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads,
                                      head_dim=cfg.head_dim,
                                      sharder=self._sharder)
                x = self._residual(x, torch.tanh(cp.gate).to(x.dtype) * y)
                return self._residual(
                    x, L.mlp(cp.mlp, L.rms_norm(cp.ln2, x), gated=True))
            x = _maybe_remat(remat, body, x)
        return x

    # ------------------------------ xlstm -----------------------------------
    def _run_xlstm(self, units, x, cache):
        """A step of one token with a cache is a decode (the recurrent
        update); a longer input with a cache is a prefill, seeded by the
        cache's state and handing its final state back."""
        cfg = self.cfg
        decode = cache is not None and x.shape[1] == 1
        remat = self._remat_on(cache)
        for u, unit in enumerate(units):
            c = _at(cache, u) if cache is not None else None

            def body(x, unit=unit, c=c):
                h = L.rms_norm(unit.m_ln, x)
                if decode:
                    ym, new_m = S.mlstm_decode(unit.mlstm, h, c["mlstm"],
                                               cfg.n_heads)
                elif c is not None:
                    ym, new_m = S.mlstm_sequence(unit.mlstm, h, cfg.n_heads,
                                                 state=c["mlstm"],
                                                 return_state=True,
                                                 sharder=self._sharder)
                else:
                    ym = S.mlstm_sequence(unit.mlstm, h, cfg.n_heads,
                                          sharder=self._sharder)
                x = x + ym
                ys, new_s = S.slstm_sequence(
                    unit.slstm, L.rms_norm(unit.s_ln, x), cfg.n_heads,
                    state=c["slstm"] if c is not None else None,
                    sharder=self._sharder)
                if c is not None:
                    _store(c, {"mlstm": new_m, "slstm": new_s})
                return self._residual(x, ys)
            x = _maybe_remat(remat, body, x)
        return x

    # --------------------------- loss ---------------------------------------
    def loss_fn(self, params: Params, batch: dict):
        """Next-token cross-entropy of ``batch["tokens"]`` (moved to the
        model's device), with the MoE balance loss at weight 0.01.
        Returns ``(loss + 0.01 * aux, {"loss": loss, "aux": aux})``: the
        reference's ``Model.loss_fn``, float32 logits of every position
        but the last against the tokens shifted by one (musicgen: per
        codebook); ``batch["image_embeds"]`` feeds the vlm."""
        tokens = batch["tokens"].to(self.device)
        image = batch.get("image_embeds")
        logits, aux, _ = self.forward(
            params, tokens,
            image_embeds=None if image is None else image.to(self.device))
        logits = logits[:, :-1].float()
        targets = tokens[:, 1:].long()
        if self.mesh is not None:
            loss = self._sharded_nll(logits, targets)
        else:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None])
            loss = nll.mean()
        return loss + 0.01 * aux, {"loss": loss, "aux": aux}

    def _sharded_nll(self, logits, targets):
        """The mean next-token loss of vocab-sharded logits, as an island:
        each rank's log-sum-exp and target logit over its vocabulary
        slice, summed over tp (the max all-reduced first), the mean over
        its rows averaged over dp."""
        sh = self.sh
        vocab = logits.shape[-1]
        v_ok = vocab % sh.tp_size == 0
        b_ok = logits.shape[0] % sh.dp_size == 0
        dp = sh.dp if b_ok else None
        lspec = (dp,) + (None,) * (logits.ndim - 2) + \
            (sh.tp if v_ok else None,)
        tspec = (dp,) + (None,) * (targets.ndim - 1)
        v_loc = vocab // sh.tp_size if v_ok else vocab
        v0 = sh.index(sh.tp) * v_loc if v_ok else 0
        tp_group = sh.group(sh.tp)

        def body(lg, tg):
            m = lg.detach().amax(-1, keepdim=True)
            if v_ok:
                m = all_reduce_nograd(m, "max", tp_group)
            sumexp = torch.exp(lg - m).sum(-1)
            ids = tg - v0
            mine = (ids >= 0) & (ids < v_loc)
            picked = torch.gather(lg, -1, torch.where(mine, ids, 0)[..., None]
                                  )[..., 0] * mine
            if v_ok:
                sumexp = psum(sumexp, tp_group)
                picked = psum(picked, tp_group)
            loss = (torch.log(sumexp) + m[..., 0] - picked).mean()
            if dp is not None:
                for a in dp:
                    loss = pmean(loss, sh.group(a), self.mesh.shape[a])
            return loss
        return island(sh, body, (logits, targets), (lspec, tspec), ())

    # cache plumbing -------------------------------------------------------
    def _cache_layout(self, batch_size: int, max_len: int) -> dict:
        """The reference's cache: a nested dict of (shape, dtype, fill,
        spec).  Positions run to ``max_len`` plus the meta tokens; KV and
        MLA leaves are in the compute dtype, the recurrent states float32
        (hymba's conv history in the compute dtype); the m states start at
        -1e30.  On a mesh ``spec`` is ``kv_cache_spec``'s layout: the batch
        over dp where it divides (else the sequence), heads over tp where
        they divide (else the sequence); the recurrent states over the
        batch where it divides, else replicated."""
        cfg, sh = self.cfg, self.sh
        dt, f32 = cfg.dtype, torch.float32
        b = batch_size
        total = max_len + cfg.n_meta_tokens

        def leaf(shape, dtype=dt, fill=0.0, **axes):
            return (shape, dtype, fill, sh.kv_cache_spec(shape, **axes))

        def rep(shape, dtype=f32, fill=0.0):
            return leaf(shape, dtype, fill, batch_axis=1, seq_axis=1,
                        head_axis=None)

        def kv(*lead):
            shape = (*lead, b, total, cfg.n_kv_heads, cfg.head_dim)
            n = len(lead)
            axes = dict(batch_axis=n, seq_axis=n + 1, head_axis=n + 2)
            return {"k": leaf(shape, **axes), "v": leaf(shape, **axes)}

        kind = cfg.block_kind
        if kind in ("gqa", "gemma", "musicgen", "gqa_moe"):
            return kv(cfg.n_layers)
        if kind == "mla_moe":
            def mla(n):
                return {"c_kv": leaf((n, b, total, cfg.kv_lora_rank),
                                     head_axis=None),
                        "k_rope": leaf((n, b, total, cfg.qk_rope_dim),
                                       head_axis=None)}
            nd = cfg.first_dense_layers
            return {"dense": mla(nd), "moe": mla(cfg.n_layers - nd)}
        if kind == "vlm":
            return {"self": kv(*self._vlm_units())}
        if kind == "xlstm":
            nu, h = cfg.n_layers // 2, cfg.n_heads
            di = cfg.d_model * 2
            dm, ds = di // h, cfg.d_model // h
            return {"mlstm": {"c": rep((nu, b, h, dm, dm)),
                              "n": rep((nu, b, h, dm)),
                              "m": rep((nu, b, h), fill=-1e30),
                              "conv": rep((nu, b, cfg.conv_kernel - 1, di))},
                    "slstm": {"c": rep((nu, b, h, ds)),
                              "n": rep((nu, b, h, ds)),
                              "h": rep((nu, b, h, ds)),
                              "m": rep((nu, b, h, ds), fill=-1e30)}}
        # hymba
        n = cfg.n_layers
        return {**kv(n),
                "conv": rep((n, b, cfg.conv_kernel - 1, cfg.d_inner), dt),
                "ssm": rep((n, b, cfg.d_inner, cfg.ssm_state))}

    def cache_shapes(self, batch_size: int, max_len: int) -> dict:
        """``meta`` tensors of the cache's shapes and dtypes."""
        return _map(lambda d: torch.empty(d[0], dtype=d[1], device="meta"),
                    self._cache_layout(batch_size, max_len))

    def cache_specs(self, batch_size: int, max_len: int) -> dict:
        """Each cache leaf's spec on the model's mesh (``()`` without
        one)."""
        return _map(lambda d: d[3], self._cache_layout(batch_size, max_len))

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The empty cache; on a mesh each leaf a DTensor laid out by its
        spec, each rank allocating only its own piece."""
        if self.mesh is None:
            return _map(lambda d: torch.full(d[0], d[2], dtype=d[1],
                                             device=self.device),
                        self._cache_layout(batch_size, max_len))
        sh = self.sh

        def make(d):
            shape, dtype, fill, spec = d
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            local = [n // math.prod(self.mesh.shape[a] for a in
                                    (e if isinstance(e, tuple) else (e,)))
                     if e is not None else n for n, e in zip(shape, spec)]
            return leave(torch.full(local, fill, dtype=dtype,
                                    device=self.device), spec, sh)
        return _map(make, self._cache_layout(batch_size, max_len))

    def prefill(self, params, tokens, cache, image_embeds=None):
        logits, _, cache = self.forward(params, tokens, cache=cache, kv_len=0,
                                        image_embeds=image_embeds,
                                        last_token_only=True)
        return logits, cache

    def decode_step(self, params, tokens, cache, pos: int,
                    image_embeds=None):
        """One-token decode.  pos: the current length, not counting the
        meta tokens."""
        logits, _, cache = self.forward(params, tokens, cache=cache,
                                        kv_len=pos + self.cfg.n_meta_tokens,
                                        image_embeds=image_embeds)
        return logits, cache
