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

On a mesh (a ``sharder`` with a mesh, DTensor activations) the attention
core runs as an island on each rank's local pieces:

- training and prefill: the reference's head-TP layout, batch over dp and
  query heads over tp (``_heads_attention``; where the KV heads do not
  divide over tp they are replicated and each local query head takes its
  own);
- context parallel, where the heads do not divide over tp
  (``context_parallel_attention``): each rank's slab of the padded query
  sequence against the full K and V, at its absolute offset;
- decode over the cache (``_cache_attention``): the cache's own layout;
  where its sequence axis is sharded, each rank's softmax over its keys
  is combined with max and sum all-reduces (flash decoding);
- the cache writes land in each rank's local piece (``_write``), never in
  a redistributed copy.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import (Dense, RMSNorm, apply_rope, dense, gather_seq,
                     init_dense, init_rmsnorm, rope_table)
from .sharding import (all_reduce_nograd, is_dtensor, island, local_offset,
                       merge_last, split_last)

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
    so the slice fits (``dynamic_update_slice``'s rule).  A DTensor
    ``buf`` is written in each rank's local piece: ``new`` is laid out
    like it with the sequence whole, and each rank writes the rows of its
    own sequence slab."""
    s = new.shape[1]
    start = min(max(int(start), 0), buf.shape[1] - s)
    if not is_dtensor(buf):
        buf[:, start:start + s] = new.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in buf.placements]
    src = new.redistribute(buf.device_mesh, want).to_local()
    shape, off = local_offset(buf)
    lo, hi = max(start, off[1]), min(start + s, off[1] + shape[1])
    if lo < hi:
        buf.to_local()[:, lo - off[1]:hi - off[1]] = \
            src[:, lo - start:hi - start].to(buf.dtype)


def _sharded(sharder, x) -> bool:
    return sharder is not None and sharder.mesh is not None and \
        is_dtensor(x)


def _heads_attention(sharder, q, k, v, **kw) -> torch.Tensor:
    """``blocked_attention`` on each rank's batch rows and query heads
    (the reference's head-TP layout, ``Sharder.heads``); K and V heads go
    with them where they divide over tp, else they are replicated and
    each local query head takes its own KV head."""
    if not _sharded(sharder, q):
        return blocked_attention(q, k, v, **kw)
    h, kh = q.shape[2], k.shape[2]
    rep = h // kh
    qspec = sharder.heads_spec(q.shape)
    tp = sharder.tp_size
    h_ok = qspec[2] is not None
    kv_ok = h_ok and kh % tp == 0
    kvspec = (qspec[0], None, sharder.tp if kv_ok else None, None)
    h_loc = h // tp if h_ok else h
    h0 = sharder.index(sharder.tp) * h_loc if h_ok else 0

    def body(ql, kl, vl):
        if h_ok and not kv_ok:
            idx = torch.arange(h0, h0 + h_loc, device=ql.device) // rep
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return blocked_attention(ql, kl, vl, **kw)
    return island(sharder, body, (q, k, v), (qspec, kvspec, kvspec), qspec)


def _axes_of(x, dim: int) -> tuple[str, ...]:
    """The mesh axes that shard dim ``dim`` of DTensor ``x``."""
    names = x.device_mesh.mesh_dim_names
    return tuple(n for n, p in zip(names, x.placements)
                 if getattr(p, "dim", None) == dim)


def _entry(axes: tuple[str, ...]):
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _cache_attention(sharder, q, k, v, *, q_offset, kv_len, window=0,
                     is_global=None, block_q=512, block_k=512,
                     softmax_scale=None) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over the whole cache k, v (B,
    Smax, KH, D/Dv) in q's dtype, keys masked from ``kv_len``.  On a mesh
    the cache keeps its layout: q goes with its batch and heads; where the
    sequence axis is sharded, a decode (S <= 4) combines the ranks' partial
    softmaxes with all-reduces, a longer query gathers the sequence."""
    kw = dict(q_offset=q_offset, causal=True, window=window,
              is_global=is_global, kv_len=kv_len, block_q=block_q,
              block_k=block_k, softmax_scale=softmax_scale)
    if not _sharded(sharder, k):
        return blocked_attention(q, k.to(q.dtype), v.to(q.dtype), **kw)
    b_ax, s_ax, h_ax = (_axes_of(k, d) for d in (0, 1, 2))
    if q.shape[1] > 4:
        s_ax = ()
    kspec = (_entry(b_ax), _entry(s_ax), _entry(h_ax), None)
    qspec = (_entry(b_ax), None, _entry(h_ax), None)
    k_off = local_offset(k)[1][1] if s_ax else 0
    names = k.device_mesh.mesh_dim_names
    groups = [(k.device_mesh, names.index(a)) for a in s_ax]

    def body(ql, kl, vl):
        kl, vl = kl.to(ql.dtype), vl.to(ql.dtype)
        if not groups:
            return blocked_attention(ql, kl, vl, **kw)
        return _combined_decode(ql, kl, vl, k_offset=k_off, groups=groups,
                                **kw)
    return island(sharder, body, (q, k, v), (qspec, kspec, kspec), qspec)


def _combined_decode(q, k, v, *, q_offset, k_offset, causal, window,
                     is_global, kv_len, softmax_scale, groups, **_):
    """``_dense_attention`` over keys sharded on the sequence: each rank
    scores its own keys (positions from ``k_offset``); the softmax's max
    and sum and the output are all-reduced over ``groups``."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    rep = h // kh
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dev = q.device
    s = _scores(q.reshape(b, sq, kh, rep, d), k, scale)
    mask = _block_mask(torch.arange(sq, device=dev) + q_offset,
                       torch.arange(skv, device=dev) + k_offset,
                       causal=causal, window=window, is_global=is_global,
                       kv_len=kv_len)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    for g in groups:
        m = all_reduce_nograd(m, "max", g)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    for g in groups:
        l = all_reduce_nograd(l, "sum", g)
    out = torch.einsum("bgrqk,bkgd->bqgrd", (p / l).to(v.dtype).float(),
                       v.float())
    for g in groups:
        out = all_reduce_nograd(out, "sum", g)
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def context_parallel_attention(q, k, v, *, sharder, causal=True, window=0,
                               is_global=None, block_q=512, block_k=512,
                               softmax_scale=None) -> torch.Tensor:
    """Shard the QUERY sequence over the tp axis; each rank runs blocked
    attention for its slab against the full K and V (replicated over tp).
    Used when n_heads % tp != 0, where head-TP would leave attention
    unsharded.  The sequence is padded to a multiple of tp and the padding
    cut; causality holds through each slab's absolute ``q_offset``."""
    p = sharder.tp_size
    sq = q.shape[1]
    pad = (-sq) % p
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    dpb = sharder.dp if q.shape[0] % sharder.dp_size == 0 and \
        q.shape[0] > 1 else None
    qspec = (dpb, sharder.tp, None, None)
    kvspec = (dpb, None, None, None)
    slab = (sq + pad) // p
    off = sharder.index(sharder.tp) * slab

    def body(qb, kb, vb):
        return blocked_attention(qb, kb, vb, q_offset=off, causal=causal,
                                 window=window, is_global=is_global,
                                 block_q=min(block_q, slab), block_k=block_k,
                                 softmax_scale=softmax_scale)
    out = island(sharder, body, (q, k, v), (qspec, kvspec, kvspec), qspec)
    return out[:, :sq] if pad else out


def attention(p: Attention, x: torch.Tensor, *, n_heads: int, n_kv: int,
              head_dim: int, positions: torch.Tensor, rope_theta: float = 1e4,
              window: int = 0, is_global=None, qk_norm: bool = False,
              cache: dict | None = None, kv_len=None, block_q: int = 512,
              block_k: int = 512, cp_mesh=None,
              sharder=None) -> tuple[torch.Tensor, dict | None]:
    """Self attention with an optional KV cache.

    Train/prefill: positions (S,); a prefill passes kv_len=0 and a cache to
    fill, and attends over its fresh k and v (the sequence starts there).
    Decode (a cache and S <= 4): the cache holds {'k', 'v'} (B, Smax, KH,
    D), kv_len is the current length, x the new token(s), and attention
    runs densely over the whole cache with the mask ``kv_len + S``.  The
    cache is written in place and returned.
    ``sharder``: the model's on a mesh; ``cp_mesh``: run context-parallel
    attention (the heads do not divide over tp).
    """
    b, s, _ = x.shape
    x = gather_seq(x)
    q = split_last(dense(p.wq, x), n_heads, head_dim)
    k = split_last(dense(p.wk, x), n_kv, head_dim)
    v = split_last(dense(p.wv, x), n_kv, head_dim)
    if qk_norm:
        q = _head_norm(p.q_norm, q)
        k = _head_norm(p.k_norm, k)
    cos, sin = rope_table(positions, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # the head-TP boundary for short sequences without a cache (the
    # reference's layout choice; long prefills are left to propagation)
    if sharder is not None and cache is None and cp_mesh is None and \
            s <= 8192:
        q, k, v = sharder.heads(q), sharder.heads(k), sharder.heads(v)

    new_cache = None
    if cache is not None:
        start = kv_len if kv_len is not None else 0
        _write(cache["k"], k, start)
        _write(cache["v"], v, start)
        new_cache = {"k": cache["k"], "v": cache["v"]}

    if cache is not None and s <= 4:  # decode: dense pass over the cache
        y = _cache_attention(sharder, q, cache["k"], cache["v"],
                             q_offset=positions[0], window=window,
                             is_global=is_global,
                             kv_len=(kv_len + s) if kv_len is not None
                             else None, block_q=block_q, block_k=block_k)
    elif cp_mesh is not None:  # train/prefill, context parallel
        y = context_parallel_attention(q, k, v, sharder=sharder, causal=True,
                                       window=window, is_global=is_global,
                                       block_q=block_q, block_k=block_k)
    else:  # train/prefill, head-TP
        y = _heads_attention(sharder, q, k, v, q_offset=0, causal=True,
                             window=window, is_global=is_global,
                             block_q=block_q, block_k=block_k)
    return dense(p.wo, merge_last(y)), new_cache


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
                    block_q: int = 512, block_k: int = 512,
                    sharder=None) -> torch.Tensor:
    """Non-causal attention of x (B, S, d) over kv_src (B, Skv, d_kv_in)."""
    b, s, _ = x.shape
    skv = kv_src.shape[1]
    q = split_last(dense(p.wq, x), n_heads, head_dim)
    k = split_last(dense(p.wk, kv_src), n_kv, head_dim)
    v = split_last(dense(p.wv, kv_src), n_kv, head_dim)
    y = _heads_attention(sharder, q, k, v, causal=False, block_q=block_q,
                         block_k=block_k)
    return dense(p.wo, merge_last(y))


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
                  block_k: int = 512,
                  sharder=None) -> tuple[torch.Tensor, dict | None]:
    """No cache: K and V decompressed from the latent, blocked causal
    attention (on a mesh, in the head-TP island: the reference sets no
    constraint here and leaves the layout to propagation).  With a cache (prefill and decode): the absorbed form.  The
    cache holds only ``{'c_kv' (B, Smax, kv_lora), 'k_rope' (B, Smax,
    rope)}``, written in place; queries move into the latent space
    (``q_nope`` through ``W_uk``), attention runs over ``[c_kv, k_rope]``
    with ``c_kv`` as the values, and ``W_uv`` maps the result out.  Both
    scale the scores by ``(nope + rope) ** -0.5``."""
    b, s, _ = x.shape
    hd = nope_dim + rope_dim
    x = gather_seq(x)
    q = split_last(dense(p.wq, x), n_heads, hd)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    cos, sin = rope_table(positions, rope_dim, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    dkv = dense(p.wdkv, x)
    c_kv = _head_norm(p.kv_norm, dkv[..., :kv_lora])
    k_rope = apply_rope(dkv[..., None, kv_lora:], cos, sin)  # (B, S, 1, rope)
    wuk = split_last(p.wuk.w.to(x.dtype), n_heads, nope_dim)
    wuv = split_last(p.wuv.w.to(x.dtype), n_heads, v_dim)

    if cache is None:
        k_nope = torch.einsum("bsc,chd->bshd", c_kv, wuk)
        v = torch.einsum("bsc,chd->bshd", c_kv, wuv)
        k = torch.cat([k_nope, k_rope.expand(b, s, n_heads, rope_dim)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        y = _heads_attention(sharder, qq, k, v, causal=True,
                             block_q=block_q, block_k=block_k,
                             softmax_scale=hd ** -0.5)
        return dense(p.wo, merge_last(y)), None

    start = kv_len if kv_len is not None else 0
    _write(cache["c_kv"], c_kv, start)
    _write(cache["k_rope"], k_rope[:, :, 0], start)
    q_abs = torch.einsum("bshd,chd->bshc", q_nope, wuk)    # (B, S, H, kv_lora)
    qq = torch.cat([q_abs, q_rope], -1)
    kk = torch.cat([cache["c_kv"], cache["k_rope"]],
                   -1)[:, :, None, :].to(x.dtype)         # (B, Smax, 1, c + r)
    y_lat = _cache_attention(sharder, qq, kk, kk[..., :kv_lora],
                             q_offset=positions[0],
                             kv_len=(kv_len + s) if kv_len is not None
                             else None, block_q=block_q, block_k=block_k,
                             softmax_scale=hd ** -0.5)    # (B, S, H, kv_lora)
    y = torch.einsum("bshc,chd->bshd", y_lat, wuv)
    return dense(p.wo, merge_last(y)), \
        {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}
