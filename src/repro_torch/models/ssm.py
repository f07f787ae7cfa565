"""Recurrent sequence mixers: xLSTM (mLSTM + sLSTM) and the Mamba-style
selective SSM, the reference package's ``models/ssm.py`` on one device.

All are O(S) in sequence length with an O(1) decode state.

mLSTM: matrix-memory LSTM with exponential gating (arXiv:2405.04517).
  Prefill uses the stabilized chunkwise form: quadratic attention within
  a chunk, the recurrent state handed from chunk to chunk (a loop over
  chunks), stabilized by running max-exponents (the paper's m state).
  Decode uses the O(1) recurrent update.

sLSTM: scalar-memory LSTM with a hidden-to-hidden recurrence, so a loop
  over time (block-diagonal recurrence per head).

Mamba: selective SSM (input-dependent dt, B, C; diagonal A).  Within a
  chunk the linear recurrence runs as a log-depth scan (doubling steps of
  the associative operator, as ``jax.lax.associative_scan`` composes it,
  up to summation order); the state is carried from chunk to chunk.

On a mesh the recurrences run as islands on each rank's batch rows (the
mLSTM chunk loop, the sLSTM time loop) and, for mamba, on its channels:
``mamba_mix(sharder=)`` shards the d_inner channels of the (B, S, d_inner,
state) scan over tp where they divide, as the reference's does.

The float32 parameters the reference multiplies without a cast
(``slstm.wx.w``, ``slstm.rh.w``, ``mlstm.wif.w``, ``mamba.w_dt.w`` and the
biases, ``a_log``, ``d_skip``) stay float32 here too; the other dense
weights and the conv taps are cast to the activation dtype at use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (Dense, Node, _gelu, _init, dense, init_dense,
                     init_rmsnorm, matmul, rms_norm)
from .sharding import is_dtensor, island, merge_last, split_last

F32 = torch.float32


def _vector(gen, values: torch.Tensor) -> torch.Tensor:
    """A fixed float32 vector on the generator's device (``meta`` with no
    generator)."""
    return values.to("meta" if gen is None else gen.device)


def _batch_island(sharder, x) -> bool:
    """Whether the recurrence runs as an island (x is a DTensor on the
    sharder's mesh)."""
    return sharder is not None and sharder.mesh is not None and \
        is_dtensor(x)


def _bspec(sharder, b: int, nd: int) -> tuple:
    """Batch over dp where it divides, the rest replicated."""
    ok = b % sharder.dp_size == 0 and b > 1
    return (sharder.dp if ok else None,) + (None,) * (nd - 1)


# ==========================================================================
# causal depthwise conv (the mamba / mLSTM front conv)
# ==========================================================================
def init_conv1d(gen, d: int, k: int) -> Dense:
    return Dense(_init(gen, (k, d), scale=k ** -0.5))


def conv1d(p: Dense, x: torch.Tensor, state: torch.Tensor | None = None):
    """x: (B, S, D) causal depthwise conv; state: (B, k-1, D) history for
    decode.  Returns (y, new_state)."""
    k = p.w.shape[0]
    w = p.w.to(x.dtype)
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else x[:, :0]
    return y, new_state


# ==========================================================================
# mLSTM
# ==========================================================================
def init_mlstm(gen, d: int, n_heads: int, proj_factor: float = 2.0,
               conv_k: int = 4) -> Node:
    di = int(d * proj_factor)
    bias = torch.cat([torch.zeros(n_heads), 3.0 * torch.ones(n_heads)])
    return Node(
        in_up=init_dense(gen, d, 2 * di),          # x branch + gate branch
        conv=init_conv1d(gen, di, conv_k),
        wq=init_dense(gen, di, di),
        wk=init_dense(gen, di, di),
        wv=init_dense(gen, di, di),
        wif=Node(w=_init(gen, (di, 2 * n_heads), scale=di ** -0.5),
                 b=_vector(gen, bias)),
        skip=init_dense(gen, di, di),
        out=init_dense(gen, di, d),
        mnorm=init_rmsnorm(di, gen))


def _mlstm_chunk(q, k, v, li, lf, state):
    """One stabilized chunk.  q, k, v: (B, H, L, dh) float32; li, lf: (B,
    H, L) float32 logs.  state = (C (B, H, dh, dh), n (B, H, dh), m (B,
    H)).  Returns (h, new_state)."""
    L = q.shape[2]
    cum = torch.cumsum(lf, dim=-1)                     # (B, H, L)
    total = cum[..., -1:]
    m_prev = state[2][..., None]                       # (B, H, 1)

    # intra-chunk exponents D[a, b] = cum[a] - cum[b] + li[b]  (a >= b)
    dmat = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    dmat = torch.where(causal, dmat, -torch.inf)
    # inter exponent for query a: cum[a] + m_prev
    g = cum + m_prev                                   # (B, H, L)
    m_q = torch.maximum(dmat.amax(-1), g)              # (B, H, L)

    scale = q.shape[-1] ** -0.5
    w_exp = torch.exp(dmat - m_q[..., None])           # gate weights only
    scores = torch.einsum("bhad,bhcd->bhac", q, k) * scale
    w_intra = scores * w_exp
    h_intra = torch.einsum("bhac,bhcd->bhad", w_intra, v)
    qc = torch.einsum("bhad,bhde->bhae", q * scale, state[0])
    h_inter = qc * torch.exp(g - m_q)[..., None]
    num = h_intra + h_inter

    # the normalizer uses the gate weights only (q enters once, in the
    # final |q . n|), as the recurrent form n_t = f n + i k does
    n_intra = torch.einsum("bhac,bhcd->bhad", w_exp, k)
    n_inter = state[1][..., None, :] * torch.exp(g - m_q)[..., None]
    # denominator: max(|q . n|, exp(-m_q)) in stabilized units
    dot = torch.einsum("bhad,bhad->bha", q * scale, n_intra + n_inter)
    den = torch.maximum(dot.abs(), torch.exp(-m_q))
    h = num / den[..., None]

    # state handoff
    a_b = total - cum + li                             # (B, H, L)
    m_new = torch.maximum(state[2] + total[..., 0], a_b.amax(-1))
    carry_scale = torch.exp(state[2] + total[..., 0] - m_new)
    w_state = torch.exp(a_b - m_new[..., None])        # (B, H, L)
    kw = k * w_state[..., None]
    c_new = state[0] * carry_scale[..., None, None] + \
        torch.einsum("bhld,bhle->bhde", kw, v)
    n_new = state[1] * carry_scale[..., None] + kw.sum(2)
    return h, (c_new, n_new, m_new)


def _mlstm_front(p: Node, x: torch.Tensor, conv_state):
    """The block's projections: (xb, zb, cx = silu(conv(xb)), the new conv
    state)."""
    up = dense(p.in_up, x)
    di = up.shape[-1] // 2
    xb, zb = up[..., :di], up[..., di:]
    cx, conv_state = conv1d(p.conv, xb, conv_state)
    return xb, zb, F.silu(cx), conv_state


def _mlstm_out(p: Node, h, x, cx, zb):
    """Head-wise norm, learnable skip, output gate, down projection."""
    h = rms_norm(p.mnorm, h.to(x.dtype))
    h = h + dense(p.skip, cx)
    h = h * F.silu(zb)
    return dense(p.out, h)


def _mlstm_loop(q, k, v, gates, *st, n_heads: int, chunk: int):
    """The gates' logs and the chunk loop over q, k, v (B, H, S, dh)
    float32 and the gate pre-activations (B, S, 2H): (h (B, H, S, dh), the
    final state)."""
    b, h, s, dh = q.shape
    li = gates[..., :n_heads].transpose(1, 2)          # log input gate
    lf = F.logsigmoid(gates[..., n_heads:]).transpose(1, 2)
    lc = min(chunk, s)
    nchunks = -(-s // lc)
    pad = nchunks * lc - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, pad), value=-1e30)
        lf = F.pad(lf, (0, pad))
    if not st:
        st = (torch.zeros((b, h, dh, dh), dtype=F32, device=q.device),
              torch.zeros((b, h, dh), dtype=F32, device=q.device),
              torch.full((b, h), -1e30, dtype=F32, device=q.device))
    hs = []
    for i in range(nchunks):
        part = slice(i * lc, (i + 1) * lc)
        hh, st = _mlstm_chunk(q[:, :, part], k[:, :, part], v[:, :, part],
                              li[..., part], lf[..., part], st)
        hs.append(hh)
    return (torch.cat(hs, dim=2)[:, :, :s],) + tuple(st)


def mlstm_sequence(p: Node, x: torch.Tensor, n_heads: int, chunk: int = 128,
                   state: dict | None = None, return_state: bool = False,
                   sharder=None):
    """Full-sequence mLSTM block (prefill).  x: (B, S, d).  ``state`` (the
    decode-cache dict) seeds the recurrence; with ``return_state`` the
    final ``{c, n, m, conv}`` (float32) is returned too, so a prefill
    hands off to decode.  On a mesh the chunk loop is an island over the
    batch."""
    b, s, _ = x.shape
    conv_in = state["conv"] if state is not None else None
    xb, zb, cx, conv_state = _mlstm_front(p, x, conv_in)
    di = xb.shape[-1]
    dh = di // n_heads

    def heads(t):
        return split_last(t, n_heads, dh).transpose(1, 2).float()

    q, k = heads(dense(p.wq, cx)), heads(dense(p.wk, cx))
    v = heads(dense(p.wv, xb))
    gates = matmul(xb.float(), p.wif.w) + p.wif.b
    st = ()
    if state is not None:
        st = (state["c"].float(), state["n"].float(), state["m"].float())
    args = (q, k, v, gates) + st

    def loop(*a):
        return _mlstm_loop(*a, n_heads=n_heads, chunk=chunk)
    if _batch_island(sharder, q):
        specs = [_bspec(sharder, b, t.ndim) for t in args]
        out_specs = (_bspec(sharder, b, 4), _bspec(sharder, b, 4),
                     _bspec(sharder, b, 3), _bspec(sharder, b, 2))
        h, *st = island(sharder, loop, args, specs, out_specs)
    else:
        h, *st = loop(*args)
    h = merge_last(h.transpose(1, 2))
    y = _mlstm_out(p, h, x, cx, zb)
    if return_state:
        return y, {"c": st[0], "n": st[1], "m": st[2],
                   "conv": conv_state.float()}
    return y


def mlstm_decode_init(b: int, n_heads: int, di: int, conv_k: int,
                      dtype=F32, device=None) -> dict:
    dh = di // n_heads
    return {"c": torch.zeros((b, n_heads, dh, dh), dtype=dtype,
                             device=device),
            "n": torch.zeros((b, n_heads, dh), dtype=dtype, device=device),
            "m": torch.full((b, n_heads), -1e30, dtype=dtype, device=device),
            "conv": torch.zeros((b, conv_k - 1, di), dtype=dtype,
                                device=device)}


def mlstm_decode(p: Node, x: torch.Tensor, cache: dict, n_heads: int):
    """One-token step.  x: (B, 1, d).  Returns (y, new cache); the conv
    state comes back in the activation dtype, as the reference's does."""
    b = x.shape[0]
    xb, zb, cx, conv_state = _mlstm_front(p, x, cache["conv"])
    di = xb.shape[-1]
    dh = di // n_heads
    q = split_last(dense(p.wq, cx)[:, 0], n_heads, dh).float() * dh ** -0.5
    k = split_last(dense(p.wk, cx)[:, 0], n_heads, dh).float()
    v = split_last(dense(p.wv, xb)[:, 0], n_heads, dh).float()
    gates = (xb[:, 0].float() @ p.wif.w) + p.wif.b
    li, lf = gates[..., :n_heads], F.logsigmoid(gates[..., n_heads:])
    m_new = torch.maximum(lf + cache["m"], li)
    fs = torch.exp(lf + cache["m"] - m_new)[..., None]
    is_ = torch.exp(li - m_new)[..., None]
    c = cache["c"] * fs[..., None] + \
        is_[..., None] * k[..., :, None] * v[..., None, :]
    n = cache["n"] * fs + is_ * k
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    h = merge_last(num / den)[:, None]
    y = _mlstm_out(p, h, x, cx, zb)
    return y, {"c": c, "n": n, "m": m_new, "conv": conv_state}


# ==========================================================================
# sLSTM
# ==========================================================================
def init_slstm(gen, d: int, n_heads: int) -> Node:
    dh = d // n_heads
    bias = torch.cat([torch.zeros(2 * d), 3.0 * torch.ones(d),
                      torch.zeros(d)])
    return Node(
        wx=Node(w=_init(gen, (d, 4 * d), scale=d ** -0.5)),
        rh=Node(w=_init(gen, (n_heads, dh, 4 * dh), scale=dh ** -0.5)),
        bias=_vector(gen, bias),
        gnorm=init_rmsnorm(d, gen),
        up=init_dense(gen, d, int(d * 4 / 3)),
        down=init_dense(gen, int(d * 4 / 3), d))


def _slstm_loop(wx, rh, c=None, n=None, h=None, m=None):
    """The time loop: (h of every step (B, S, H, dh), c, n, h, m)."""
    b, s, _, n_heads, dh = wx.shape
    if c is None:
        z = torch.zeros((b, n_heads, dh), dtype=F32, device=wx.device)
        c, n, h = z, z, z
        m = torch.full((b, n_heads, dh), -1e30, dtype=F32, device=wx.device)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h, rh).reshape(b, n_heads, 4, dh)
        pre = wx[:, t] + rec.transpose(1, 2)            # (B, 4, H, dh)
        zi = torch.tanh(pre[:, 0])
        ii = pre[:, 1]
        oo = torch.sigmoid(pre[:, 3])
        lfm = F.logsigmoid(pre[:, 2]) + m
        m_new = torch.maximum(lfm, ii)
        fs = torch.exp(lfm - m_new)
        is_ = torch.exp(ii - m_new)
        c = fs * c + is_ * zi
        n = fs * n + is_
        h = oo * c / torch.maximum(n.abs(), torch.exp(-m_new))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h, m


def slstm_sequence(p: Node, x: torch.Tensor, n_heads: int,
                   state: dict | None = None, sharder=None):
    """x: (B, S, d), a loop over time (a true recurrence).  Returns (y,
    state); the state is ``{c, n, h, m}``, each (B, H, dh) float32.  On a
    mesh the time loop is an island over the batch."""
    b, s, d = x.shape
    dh = d // n_heads
    wx = matmul(x.float(), p.wx.w) + p.bias             # (B, S, 4d)
    wx = split_last(wx, 4, n_heads, dh)
    st = () if state is None else \
        (state["c"], state["n"], state["h"], state["m"])
    if _batch_island(sharder, wx):
        args = (wx, p.rh.w) + st
        specs = [_bspec(sharder, b, 5), (None, None, None)] + \
            [_bspec(sharder, b, 3)] * len(st)
        hs, c, n, h, m = island(sharder, _slstm_loop, args, specs,
                                (_bspec(sharder, b, 4),)
                                + (_bspec(sharder, b, 3),) * 4)
    else:
        hs, c, n, h, m = _slstm_loop(wx, p.rh.w, *st)
    y = merge_last(hs).to(x.dtype)
    y = rms_norm(p.gnorm, y)
    y = dense(p.down, _gelu(dense(p.up, y)))
    return y, {"c": c, "n": n, "h": h, "m": m}


# ==========================================================================
# Mamba (selective SSM)
# ==========================================================================
def init_mamba(gen, d: int, d_inner: int, state: int = 16, conv_k: int = 4,
               dt_rank: int | None = None) -> Node:
    dt_rank = dt_rank or max(1, d // 16)
    dt_bias = torch.full((d_inner,), float(torch.log(torch.expm1(
        torch.tensor(0.01)))))
    a_log = torch.log(torch.arange(1, state + 1, dtype=F32)
                      ).repeat(d_inner, 1)
    return Node(
        in_proj=init_dense(gen, d, 2 * d_inner),
        conv=init_conv1d(gen, d_inner, conv_k),
        wx_bc=init_dense(gen, d_inner, 2 * state),
        wx_dt=init_dense(gen, d_inner, dt_rank),
        w_dt=Node(w=_init(gen, (dt_rank, d_inner), scale=dt_rank ** -0.5),
                  b=_vector(gen, dt_bias)),
        a_log=_vector(gen, a_log),
        d_skip=_vector(gen, torch.ones(d_inner)),
        out_proj=init_dense(gen, d_inner, d))


def _mamba_scan(decay, binp, h0, chunk: int):
    """h_t = decay_t * h_{t-1} + binp_t, in chunks.  decay, binp: (B, S,
    di, st) float32; h0: (B, di, st).  Returns (hs, h_final).

    Within a chunk, log2(chunk) doubling steps of the operator (a1, b1) ∘
    (a2, b2) = (a1·a2, a2·b1 + b2) give every prefix at once (all chunks
    together); then the state runs from chunk to chunk."""
    b, s, di, st = decay.shape
    lc = min(chunk, s)
    nch = -(-s // lc)
    pad = nch * lc - s
    if pad:
        decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
        binp = F.pad(binp, (0, 0, 0, 0, 0, pad))
    acc_d = decay.reshape(b, nch, lc, di, st)
    acc_b = binp.reshape(b, nch, lc, di, st)
    step = 1
    while step < lc:
        acc_d, acc_b = (
            torch.cat([acc_d[:, :, :step],
                       acc_d[:, :, :-step] * acc_d[:, :, step:]], dim=2),
            torch.cat([acc_b[:, :, :step],
                       acc_d[:, :, step:] * acc_b[:, :, :-step]
                       + acc_b[:, :, step:]], dim=2))
        step *= 2
    h = h0
    chunks = []
    for i in range(nch):
        hs = acc_d[:, i] * h[:, None] + acc_b[:, i]     # (B, lc, di, st)
        h = hs[:, -1]
        chunks.append(hs)
    hs = torch.cat(chunks, dim=1)[:, :s]
    return hs, h


def _scan_out(decay, binp, h0, cmat, chunk: int):
    """The scan and its read-out: (y (B, S, di) float32, h_final)."""
    hs, h_fin = _mamba_scan(decay, binp, h0, chunk)
    return torch.einsum("bsdk,bsk->bsd", hs, cmat), h_fin


def mamba_mix(p: Node, x: torch.Tensor, conv_state=None, ssm_state=None,
              chunk: int = 128, sharder=None):
    """Mamba mixer.  x: (B, S, d).  Returns (y, (conv_state, ssm_state)).
    With states given it continues from them (decode: S = 1).
    ``sharder``: shard the d_inner channel axis over tp (where it divides),
    the batch over dp; the (B, S, di, st) scan tensors are the hybrid
    archs' largest activations, and the scan runs as an island on each
    rank's channels."""
    b, s, _ = x.shape
    di = p.in_proj.w.shape[-1] // 2
    st = p.a_log.shape[-1]
    on_mesh = sharder is not None and sharder.mesh is not None
    split = on_mesh and di % sharder.mesh.shape[sharder.tp] == 0

    def spec(t) -> tuple:
        """The channel-sharded layout: the reference's ``ch``."""
        ax = t.ndim - 1 - (1 if t.shape[-1] == st else 0)
        out = [None] * t.ndim
        if t.shape[0] % sharder.dp_size == 0 and t.shape[0] > 1:
            out[0] = sharder.dp
        if split:
            out[ax] = sharder.tp
        return tuple(out)

    def ch(t):
        return sharder(t, *spec(t)) if split else t

    xz = dense(p.in_proj, x)
    xb, z = xz[..., :di], xz[..., di:]
    cx, conv_state = conv1d(p.conv, ch(xb), conv_state)
    cx = F.silu(cx)

    bc = dense(p.wx_bc, cx).float()
    bmat, cmat = bc[..., :st], bc[..., st:]
    dt = matmul(dense(p.wx_dt, cx).float(), p.w_dt.w) + p.w_dt.b
    dt = F.softplus(dt)                                  # (B, S, di)
    a = -torch.exp(p.a_log)                              # (di, st)
    decay = ch(torch.exp(dt[..., None] * a))             # (B, S, di, st)
    binp = ch((dt * cx.float())[..., None] * bmat[:, :, None, :])
    if ssm_state is None:
        ssm_state = torch.zeros((b, di, st), dtype=F32, device=x.device)
    if on_mesh and is_dtensor(decay):
        y, h_fin = island(
            sharder, lambda d_, b_, h_, c_: _scan_out(d_, b_, h_, c_, chunk),
            (decay, binp, ssm_state, cmat),
            (spec(decay), spec(binp), spec(ssm_state), spec(cmat)[:1]
             + (None, None)),
            (spec(decay)[:3], spec(ssm_state)))
    else:
        y, h_fin = _scan_out(decay, binp, ssm_state, cmat, chunk)
    y = y + cx.float() * p.d_skip
    y = y.to(x.dtype) * F.silu(z)
    return dense(p.out_proj, y), (conv_state, h_fin)
