"""Attention: blocked flash-style softmax attention, GQA/MQA, sliding
window, the self-attention layer with its KV cache, cross-attention over
image tokens and MLA (DeepSeek's multi-head latent attention).

The reference package's ``models/attention.py`` on one device (its
``lax.scan`` over query and key blocks becomes a Python loop over the
same blocks).  The numerics are the reference's: scores and the
PV product accumulate in float32 from the inputs' values, probabilities
are cast to v's dtype before the PV product, masked scores are the finite
``NEG_INF`` and the output is divided by ``max(l, 1e-30)``, so a fully
masked row gives no NaN.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import (Dense, RMSNorm, apply_rope, dense, init_dense,
                     init_rmsnorm, rope_table)

NEG_INF = -1e30


# --------------------------------------------------------------------------
# blocked attention core
# --------------------------------------------------------------------------
def _block_mask(q_pos, k_pos, *, causal: bool, window: int, is_global,
                kv_len) -> torch.Tensor:
    """(Bq, Bk) bool mask.  window > 0 limits lookback; is_global (a bool,
    a bool tensor or None) switches the window off per layer; kv_len (int,
    tensor or None) masks the cache tail."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window:
        in_win = (q_pos[:, None] - k_pos[None, :]) < window
        if is_global is None:
            m &= in_win
        else:
            m &= torch.logical_or(torch.as_tensor(is_global,
                                                  device=m.device), in_win)
    if kv_len is not None:
        m &= k_pos[None, :] < kv_len
    return m


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Q, G, R, D) x (B, K, G, D) -> (B, G, R, Q, K) in float32."""
    return torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset=0, causal: bool = True, window: int = 0,
                      is_global=None, kv_len=None, block_q: int = 512,
                      block_k: int = 512,
                      softmax_scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KH, Dk/Dv) with H % KH == 0 (GQA).

    Returns (B, Sq, H, Dv).  Online softmax over KV blocks, for each Q
    block; float32 accumulation.  Sq <= 4 takes one dense pass.  The
    scores are scaled by ``softmax_scale``, by default ``D ** -0.5``.
    """
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    rep = h // kh

    if sq <= 4:
        return _dense_attention(q, k, v, q_offset=q_offset, causal=causal,
                                window=window, is_global=is_global,
                                kv_len=kv_len, scale=scale)

    bq = min(block_q, sq)
    nq = -(-sq // bq)
    pad_q = nq * bq - sq
    bk = min(block_k, skv)
    nk = -(-skv // bk)
    pad_k = nk * bk - skv

    dev = q.device
    qf = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    # pad positions beyond the real kv range so masks kill them
    k_positions = torch.arange(nk * bk, device=dev)
    q_positions = torch.arange(nq * bq, device=dev) + q_offset
    kv_len_eff = skv if kv_len is None else kv_len

    blocks = []
    for i in range(nq):
        # grouped GQA: contract per kv-head group, no repeat of k and v
        qg = qf[:, i * bq:(i + 1) * bq].reshape(b, bq, kh, rep, d)
        qpos = q_positions[i * bq:(i + 1) * bq]
        m = torch.full((b, kh, rep, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, rep, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, rep, bq, dv), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kb = kf[:, j * bk:(j + 1) * bk]
            vb = vf[:, j * bk:(j + 1) * bk]
            s = _scores(qg, kb, scale)
            mask = _block_mask(qpos, k_positions[j * bk:(j + 1) * bk],
                               causal=causal, window=window,
                               is_global=is_global, kv_len=kv_len_eff)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        # (B, KH, rep, bq, Dv) -> (B, bq, H, Dv)
        blocks.append(out.permute(0, 3, 1, 2, 4).reshape(b, bq, h, dv))
    out = torch.cat(blocks, dim=1)
    return out[:, :sq].to(q.dtype)


def _dense_attention(q, k, v, *, q_offset, causal, window, is_global,
                     kv_len, scale):
    """Decode path: one dense pass over every key, grouped GQA."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qg = q.reshape(b, sq, kh, rep, d)
    s = _scores(qg, k, scale)
    dev = q.device
    mask = _block_mask(torch.arange(sq, device=dev) + q_offset,
                       torch.arange(skv, device=dev), causal=causal,
                       window=window, is_global=is_global, kv_len=kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# GQA self-attention layer
# --------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense,
                 q_norm: RMSNorm | None = None, k_norm: RMSNorm | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   qk_norm: bool = False) -> Attention:
    wq = init_dense(gen, d_model, n_heads * head_dim)
    wk = init_dense(gen, d_model, n_kv * head_dim)
    wv = init_dense(gen, d_model, n_kv * head_dim)
    wo = init_dense(gen, n_heads * head_dim, d_model)
    if not qk_norm:
        return Attention(wq, wk, wv, wo)
    return Attention(wq, wk, wv, wo, init_rmsnorm(head_dim, gen),
                     init_rmsnorm(head_dim, gen))


def _head_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the head dim; the float32 scale is used uncast."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)


def _write(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``buf[:, start:start + s] = new`` in place, with the start clamped
    so the slice fits (``dynamic_update_slice``'s rule)."""
    s = new.shape[1]
    start = min(max(int(start), 0), buf.shape[1] - s)
    buf[:, start:start + s] = new.to(buf.dtype)


def attention(p: Attention, x: torch.Tensor, *, n_heads: int, n_kv: int,
              head_dim: int, positions: torch.Tensor, rope_theta: float = 1e4,
              window: int = 0, is_global=None, qk_norm: bool = False,
              cache: dict | None = None, kv_len=None, block_q: int = 512,
              block_k: int = 512) -> tuple[torch.Tensor, dict | None]:
    """Self attention with an optional KV cache.

    Train/prefill: positions (S,); a prefill passes kv_len=0 and a cache to
    fill, and attends over its fresh k and v (the sequence starts there).
    Decode (a cache and S <= 4): the cache holds {'k', 'v'} (B, Smax, KH,
    D), kv_len is the current length, x the new token(s), and attention
    runs densely over the whole cache with the mask ``kv_len + S``.  The
    cache is written in place and returned.
    """
    b, s, _ = x.shape
    q = dense(p.wq, x).reshape(b, s, n_heads, head_dim)
    k = dense(p.wk, x).reshape(b, s, n_kv, head_dim)
    v = dense(p.wv, x).reshape(b, s, n_kv, head_dim)
    if qk_norm:
        q = _head_norm(p.q_norm, q)
        k = _head_norm(p.k_norm, k)
    cos, sin = rope_table(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        start = kv_len if kv_len is not None else 0
        _write(cache["k"], k, start)
        _write(cache["v"], v, start)
        new_cache = {"k": cache["k"], "v": cache["v"]}

    if cache is not None and s <= 4:  # decode: dense pass over the cache
        y = blocked_attention(q, cache["k"].to(q.dtype),
                              cache["v"].to(q.dtype), q_offset=positions[0],
                              causal=True, window=window, is_global=is_global,
                              kv_len=(kv_len + s) if kv_len is not None else None,
                              block_q=block_q, block_k=block_k)
    else:  # train/prefill
        y = blocked_attention(q, k, v, q_offset=0, causal=True, window=window,
                              is_global=is_global, block_q=block_q,
                              block_k=block_k)
    return dense(p.wo, y.reshape(b, s, n_heads * head_dim)), new_cache


# --------------------------------------------------------------------------
# cross-attention (the VLM's layers; K and V from precomputed image tokens)
# --------------------------------------------------------------------------
def init_cross_attention(gen, d_model: int, n_heads: int, n_kv: int,
                         head_dim: int, d_kv_in: int | None = None
                         ) -> Attention:
    d_kv_in = d_kv_in or d_model
    return Attention(init_dense(gen, d_model, n_heads * head_dim),
                     init_dense(gen, d_kv_in, n_kv * head_dim),
                     init_dense(gen, d_kv_in, n_kv * head_dim),
                     init_dense(gen, n_heads * head_dim, d_model))


def cross_attention(p: Attention, x: torch.Tensor, kv_src: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Non-causal attention of x (B, S, d) over kv_src (B, Skv, d_kv_in)."""
    b, s, _ = x.shape
    skv = kv_src.shape[1]
    q = dense(p.wq, x).reshape(b, s, n_heads, head_dim)
    k = dense(p.wk, kv_src).reshape(b, skv, n_kv, head_dim)
    v = dense(p.wv, kv_src).reshape(b, skv, n_kv, head_dim)
    y = blocked_attention(q, k, v, causal=False, block_q=block_q,
                          block_k=block_k)
    return dense(p.wo, y.reshape(b, s, n_heads * head_dim))


# --------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# --------------------------------------------------------------------------
class MLA(nn.Module):
    def __init__(self, wq: Dense, wdkv: Dense, kv_norm: RMSNorm, wuk: Dense,
                 wuv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wdkv, self.kv_norm = wq, wdkv, kv_norm
        self.wuk, self.wuv, self.wo = wuk, wuv, wo


def init_mla(gen, d_model: int, n_heads: int, *, kv_lora: int,
             nope_dim: int, rope_dim: int, v_dim: int) -> MLA:
    return MLA(init_dense(gen, d_model, n_heads * (nope_dim + rope_dim)),
               init_dense(gen, d_model, kv_lora + rope_dim),
               init_rmsnorm(kv_lora, gen),
               init_dense(gen, kv_lora, n_heads * nope_dim),
               init_dense(gen, kv_lora, n_heads * v_dim),
               init_dense(gen, n_heads * v_dim, d_model))


def mla_attention(p: MLA, x: torch.Tensor, *, n_heads: int, kv_lora: int,
                  nope_dim: int, rope_dim: int, v_dim: int,
                  positions: torch.Tensor, rope_theta: float = 1e4,
                  cache: dict | None = None, kv_len=None, block_q: int = 512,
                  block_k: int = 512) -> tuple[torch.Tensor, dict | None]:
    """No cache: K and V decompressed from the latent, blocked causal
    attention.  With a cache (prefill and decode): the absorbed form.  The
    cache holds only ``{'c_kv' (B, Smax, kv_lora), 'k_rope' (B, Smax,
    rope)}``, written in place; queries move into the latent space
    (``q_nope`` through ``W_uk``), attention runs over ``[c_kv, k_rope]``
    with ``c_kv`` as the values, and ``W_uv`` maps the result out.  Both
    scale the scores by ``(nope + rope) ** -0.5``."""
    b, s, _ = x.shape
    hd = nope_dim + rope_dim
    q = dense(p.wq, x).reshape(b, s, n_heads, hd)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    cos, sin = rope_table(positions, rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    dkv = dense(p.wdkv, x)
    c_kv = _head_norm(p.kv_norm, dkv[..., :kv_lora])
    k_rope = apply_rope(dkv[..., None, kv_lora:], cos, sin)  # (B, S, 1, rope)
    wuk = p.wuk.w.to(x.dtype).reshape(kv_lora, n_heads, nope_dim)
    wuv = p.wuv.w.to(x.dtype).reshape(kv_lora, n_heads, v_dim)

    if cache is None:
        k_nope = torch.einsum("bsc,chd->bshd", c_kv, wuk)
        v = torch.einsum("bsc,chd->bshd", c_kv, wuv)
        k = torch.cat([k_nope, k_rope.expand(b, s, n_heads, rope_dim)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        y = blocked_attention(qq, k, v, causal=True, block_q=block_q,
                              block_k=block_k, softmax_scale=hd ** -0.5)
        return dense(p.wo, y.reshape(b, s, n_heads * v_dim)), None

    start = kv_len if kv_len is not None else 0
    _write(cache["c_kv"], c_kv, start)
    _write(cache["k_rope"], k_rope[:, :, 0], start)
    q_abs = torch.einsum("bshd,chd->bshc", q_nope, wuk)    # (B, S, H, kv_lora)
    qq = torch.cat([q_abs, q_rope], -1)
    kk = torch.cat([cache["c_kv"], cache["k_rope"]],
                   -1)[:, :, None, :].to(x.dtype)         # (B, Smax, 1, c + r)
    y_lat = blocked_attention(qq, kk, kk[..., :kv_lora],
                              q_offset=positions[0], causal=True,
                              kv_len=(kv_len + s) if kv_len is not None
                              else None, block_q=block_q, block_k=block_k,
                              softmax_scale=hd ** -0.5)   # (B, S, H, kv_lora)
    y = torch.einsum("bshc,chd->bshd", y_lat, wuv)
    return dense(p.wo, y.reshape(b, s, n_heads * v_dim)), \
        {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}
