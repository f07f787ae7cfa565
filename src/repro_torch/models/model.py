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

Sharded models wait for a later slice (``ROADMAP.md`` queue 1, item 7d).
"""

from __future__ import annotations

import re

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S

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


def _store(views: dict, new: dict) -> None:
    """Write each new state into its cache view, in the view's dtype."""
    for name, view in views.items():
        if isinstance(view, dict):
            _store(view, new[name])
        else:
            view.copy_(new[name])


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
        if mesh is not None:
            raise NotImplementedError(
                "sharded models come with models/sharding.py "
                "(ROADMAP.md queue 1 item 7d)")
        if cfg.block_kind not in KINDS:
            raise ValueError(f"unknown block_kind {cfg.block_kind}")
        self.cfg = cfg
        self.device = torch.device("cuda:0" if device is None else device)
        # as the reference: a model of two layers or fewer never remats
        self.remat = remat and cfg.n_layers > 2

    # --------------------------- init ------------------------------------
    def init_params(self, gen: torch.Generator) -> Params:
        """Random float32 parameters drawn from ``gen``, which lives on the
        model's device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return self._build(gen)

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
            return sum(tables[q][tokens[..., q].long()]
                       for q in range(cfg.n_codebooks))
        return L.embed(params.embed, tokens, cfg.dtype)

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = getattr(params, "lm_head", params.embed)
        if self.cfg.n_codebooks:
            tables = head.table.to(x.dtype)  # (nq, V, d)
            return torch.einsum("bsd,qvd->bsqv", x, tables)
        return L.unembed(head, x)

    # --------------------------- blocks ------------------------------------
    def _attn_block(self, p: Block, x, *, positions, is_global=None,
                    cache=None, kv_len=None):
        cfg = self.cfg
        h = L.rms_norm(p.ln1, x)
        if isinstance(p.attn, A.MLA):
            y, _ = A.mla_attention(
                p.attn, h, n_heads=cfg.n_heads, kv_lora=cfg.kv_lora_rank,
                nope_dim=cfg.qk_nope_dim, rope_dim=cfg.qk_rope_dim,
                v_dim=cfg.v_head_dim, positions=positions,
                rope_theta=cfg.rope_theta, cache=cache, kv_len=kv_len)
        else:
            y, _ = A.attention(
                p.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, positions=positions,
                rope_theta=cfg.rope_theta, window=cfg.window,
                is_global=is_global, qk_norm=cfg.qk_norm, cache=cache,
                kv_len=kv_len)
        return x + y

    def _ffn_block(self, p: Block, x):
        cfg = self.cfg
        if hasattr(p, "moe"):
            y, aux = M.moe_ffn(p.moe, L.rms_norm(p.ln2, x), top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
        else:
            y, aux = L.mlp(p.mlp, L.rms_norm(p.ln2, x), gated=cfg.mlp_gated,
                           act=cfg.mlp_act), 0.0
        return x + y, aux

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
        x = self._embed(params, tokens)
        b = x.shape[0]
        n_meta = 0
        if cfg.n_meta_tokens and (cache is None or kv_len == 0):
            meta = params.meta_tokens.to(x.dtype).expand(
                b, cfg.n_meta_tokens, x.shape[-1])
            x = torch.cat([meta, x], dim=1)
            n_meta = cfg.n_meta_tokens
        steps = torch.arange(x.shape[1], device=x.device)
        positions = steps if kv_len is None else kv_len + steps
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

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
        return self._unembed(params, x), aux_total, cache

    # ------------------ flat homogeneous stacks ----------------------------
    def _remat_on(self, cache) -> bool:
        return self.remat and cache is None and torch.is_grad_enabled()

    def _run_flat_stack(self, layers, x, positions, flags, cache, kv_len):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
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
                            cache=cache, kv_len=kv_len)
        ym, (new_conv, new_ssm) = S.mamba_mix(p.mamba, h, m_conv, m_ssm)
        if cache is not None:
            m_conv.copy_(new_conv)
            m_ssm.copy_(new_ssm)
        y = 0.5 * (L.rms_norm(p.mix_norm_a, ya)
                   + L.rms_norm(p.mix_norm_m, ym))
        return x + y

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
                                      head_dim=cfg.head_dim)
                x = x + torch.tanh(cp.gate).to(x.dtype) * y
                return x + L.mlp(cp.mlp, L.rms_norm(cp.ln2, x), gated=True)
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
                                                 return_state=True)
                else:
                    ym = S.mlstm_sequence(unit.mlstm, h, cfg.n_heads)
                x = x + ym
                ys, new_s = S.slstm_sequence(
                    unit.slstm, L.rms_norm(unit.s_ln, x), cfg.n_heads,
                    state=c["slstm"] if c is not None else None)
                if c is not None:
                    _store(c, {"mlstm": new_m, "slstm": new_s})
                return x + ys
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
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])
        loss = nll.mean()
        return loss + 0.01 * aux, {"loss": loss, "aux": aux}

    # cache plumbing -------------------------------------------------------
    def _cache_layout(self, batch_size: int, max_len: int) -> dict:
        """The reference's cache: a nested dict of (shape, dtype, fill).
        Positions run to ``max_len`` plus the meta tokens; KV and MLA
        leaves are in the compute dtype, the recurrent states float32
        (hymba's conv history in the compute dtype); the m states start at
        -1e30."""
        cfg = self.cfg
        dt, f32 = cfg.dtype, torch.float32
        b = batch_size
        total = max_len + cfg.n_meta_tokens

        def kv(*lead):
            shape = (*lead, b, total, cfg.n_kv_heads, cfg.head_dim)
            return {"k": (shape, dt, 0.0), "v": (shape, dt, 0.0)}

        kind = cfg.block_kind
        if kind in ("gqa", "gemma", "musicgen", "gqa_moe"):
            return kv(cfg.n_layers)
        if kind == "mla_moe":
            def mla(n):
                return {"c_kv": ((n, b, total, cfg.kv_lora_rank), dt, 0.0),
                        "k_rope": ((n, b, total, cfg.qk_rope_dim), dt, 0.0)}
            nd = cfg.first_dense_layers
            return {"dense": mla(nd), "moe": mla(cfg.n_layers - nd)}
        if kind == "vlm":
            return {"self": kv(*self._vlm_units())}
        if kind == "xlstm":
            nu, h = cfg.n_layers // 2, cfg.n_heads
            di = cfg.d_model * 2
            dm, ds = di // h, cfg.d_model // h
            return {"mlstm": {"c": ((nu, b, h, dm, dm), f32, 0.0),
                              "n": ((nu, b, h, dm), f32, 0.0),
                              "m": ((nu, b, h), f32, -1e30),
                              "conv": ((nu, b, cfg.conv_kernel - 1, di),
                                       f32, 0.0)},
                    "slstm": {"c": ((nu, b, h, ds), f32, 0.0),
                              "n": ((nu, b, h, ds), f32, 0.0),
                              "h": ((nu, b, h, ds), f32, 0.0),
                              "m": ((nu, b, h, ds), f32, -1e30)}}
        # hymba
        n = cfg.n_layers
        return {**kv(n),
                "conv": ((n, b, cfg.conv_kernel - 1, cfg.d_inner), dt, 0.0),
                "ssm": ((n, b, cfg.d_inner, cfg.ssm_state), f32, 0.0)}

    def cache_shapes(self, batch_size: int, max_len: int) -> dict:
        """``meta`` tensors of the cache's shapes and dtypes."""
        return _map(lambda d: torch.empty(d[0], dtype=d[1], device="meta"),
                    self._cache_layout(batch_size, max_len))

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        return _map(lambda d: torch.full(d[0], d[2], dtype=d[1],
                                         device=self.device),
                    self._cache_layout(batch_size, max_len))

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
