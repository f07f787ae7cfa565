"""The decoder: the reference package's ``models/model.py`` for the flat
stacks of the block kinds ``gqa``, ``gemma``, ``musicgen`` and
``gqa_moe``.

The reference scans one block body over stacked layer parameters; here
the stack is a loop over per-layer modules (``Params.layers``), with the
per-layer flags (gemma's local/global pattern) as Python booleans.  The
KV cache keeps the reference's layout, ``{'k', 'v'}`` of shape (L, B,
Smax, KH, D), and is written in place.

Parameters are an ``nn.Module`` tree (``Params``) whose state-dict names
are the reference's parameter paths with the layer index spliced in
(``layers.3.attn.wq.w``).  They are created by ``init_params`` from a
``torch.Generator`` on the model's device, or carried over from the
reference by ``models/convert.py``.  They stay float32, cast to the
compute dtype at use as in the reference; ``cast_params`` casts them once
instead (serving does), which gives the same numbers.

The other kinds (``mla_moe``, ``vlm``, ``xlstm``, ``hymba``) and sharded
models wait for later slices (``ROADMAP.md`` queue 1, items 7b and 7d).
"""

from __future__ import annotations

import re

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from . import attention as A
from . import layers as L
from . import moe as M

PORTED_KINDS = ("gqa", "gemma", "musicgen", "gqa_moe")
#: kinds that ``ROADMAP.md`` queue 1 item 7b ports
LATER_KINDS = ("mla_moe", "vlm", "xlstm", "hymba")

#: parameters the reference casts to the activation dtype at use: dense
#: weights (not the router's), embedding tables and the expert tables
_CAST_AT_USE_NAMES = re.compile(r"(?<!router)\.w$|\.table$|\.moe\.(up|gate|down)$")


class Block(nn.Module):
    def __init__(self, ln1, attn, ln2, ffn_name: str, ffn):
        super().__init__()
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        setattr(self, ffn_name, ffn)


class Params(nn.Module):
    def __init__(self, embed, final_norm, layers, lm_head=None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        if lm_head is not None:
            self.lm_head = lm_head
        self.layers = nn.ModuleList(layers)


def _cast_at_use(name: str) -> bool:
    """Whether the reference casts the parameter at this state-dict name to
    the activation dtype where it uses it."""
    return bool(_CAST_AT_USE_NAMES.search(name))


class Model:
    def __init__(self, cfg: ArchConfig, mesh=None,
                 device: str | torch.device | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded models come with models/sharding.py "
                "(ROADMAP.md queue 1 item 7d)")
        if cfg.block_kind in LATER_KINDS:
            raise NotImplementedError(
                f"block kind {cfg.block_kind!r} is not ported yet "
                "(ROADMAP.md queue 1 item 7b)")
        if cfg.block_kind not in PORTED_KINDS:
            raise ValueError(f"unknown block_kind {cfg.block_kind}")
        self.cfg = cfg
        self.device = torch.device("cuda:0" if device is None else device)

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
        final_norm = L.init_rmsnorm(cfg.d_model, gen)
        lm_head = None
        if not cfg.tie_embeddings:
            if cfg.n_codebooks:
                lm_head = L.Embedding(torch.stack(
                    [L.init_embedding(gen, cfg.vocab_size, cfg.d_model).table
                     for _ in range(cfg.n_codebooks)]))
            else:
                lm_head = L.init_embedding(gen, cfg.vocab_size, cfg.d_model)
        layers = [self._init_layer(gen) for _ in range(cfg.n_layers)]
        return Params(embed, final_norm, layers, lm_head)

    def _init_layer(self, gen) -> Block:
        cfg = self.cfg
        attn = A.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.qk_norm)
        if cfg.block_kind == "gqa_moe":
            ffn_name, ffn = "moe", M.init_moe(gen, cfg.d_model,
                                              cfg.d_ff_expert, cfg.n_experts,
                                              cfg.n_shared_experts)
        else:
            ffn_name, ffn = "mlp", L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                              cfg.mlp_gated)
        return Block(L.init_rmsnorm(cfg.d_model, gen), attn,
                     L.init_rmsnorm(cfg.d_model, gen), ffn_name, ffn)

    def cast_params(self, params: Params, dtype=None) -> Params:
        """The parameters with every weight the reference casts at use cast
        once to ``dtype`` (the config's compute dtype by default); norm
        scales and the router stay float32, as the reference reads them.
        Uncast tensors are shared with ``params``."""
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
        """Per-layer is_global booleans of the gemma pattern."""
        cfg = self.cfg
        if cfg.block_kind == "gemma":
            return [i % cfg.global_every == cfg.global_every - 1
                    for i in range(cfg.n_layers)]
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
        y, new_cache = A.attention(
            p.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions,
            rope_theta=cfg.rope_theta, window=cfg.window,
            is_global=is_global, qk_norm=cfg.qk_norm, cache=cache,
            kv_len=kv_len)
        return x + y, new_cache

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
    def forward(self, params: Params, tokens: torch.Tensor, *, cache=None,
                kv_len=None, last_token_only: bool = False):
        """Returns (logits, aux_loss, new_cache).  cache None: no caching
        (training).  A prefill passes an empty cache and kv_len=0;
        last_token_only skips the (B, S, V) logits (a prefill only needs
        the last position)."""
        x = self._embed(params, tokens)
        s = x.shape[1]
        steps = torch.arange(s, device=x.device)
        positions = steps if kv_len is None else kv_len + steps
        x, aux_total = self._run_flat_stack(params.layers, x, positions,
                                            self._layer_flags(), cache,
                                            kv_len)
        x = L.rms_norm(params.final_norm, x)
        if last_token_only:
            x = x[:, -1:]
        return self._unembed(params, x), aux_total, cache

    # ------------------ flat homogeneous stacks ----------------------------
    def _run_flat_stack(self, layers, x, positions, flags, cache, kv_len):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, p in enumerate(layers):
            c_in = None
            if cache is not None:
                c_in = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = self._attn_block(p, x, positions=positions,
                                    is_global=flags[i] if flags else None,
                                    cache=c_in, kv_len=kv_len)
            x, aux = self._ffn_block(p, x)
            aux_total = aux_total + aux
        return x, aux_total

    # cache plumbing -------------------------------------------------------
    def _cache_layout(self, batch_size: int, max_len: int) -> dict:
        """{'k', 'v'}: (shape, dtype) of the cache, zero-filled."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}

    def cache_shapes(self, batch_size: int, max_len: int) -> dict:
        """``meta`` tensors of the cache's shapes and dtypes."""
        return {name: torch.empty(shape, dtype=dtype, device="meta")
                for name, (shape, dtype) in
                self._cache_layout(batch_size, max_len).items()}

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in
                self._cache_layout(batch_size, max_len).items()}

    def prefill(self, params, tokens, cache):
        logits, _, cache = self.forward(params, tokens, cache=cache, kv_len=0,
                                        last_token_only=True)
        return logits, cache

    def decode_step(self, params, tokens, cache, pos: int):
        """One-token decode.  pos: the current length."""
        logits, _, cache = self.forward(params, tokens, cache=cache,
                                        kv_len=pos)
        return logits, cache
