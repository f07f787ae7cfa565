"""The port's LM layers (``repro_torch.models.layers`` / ``attention`` /
``moe``) against the reference package's, on the same inputs.

Inputs and parameters come from numpy with a fixed seed; the parameters
go to the reference as its nested dicts and to the port's modules (built
on ``meta`` by the port's ``init_*``) under the same names.  Tolerances (rel-L2): 1e-5 in float32, where only the
summation order differs; 2e-2 in bfloat16, where the two frameworks round
intermediate products at different points.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models.convert import _flatten

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the reference's layers compiled whole (faster here than op by op)
r_attention = jax.jit(r_attn.attention, static_argnames=(
    "n_heads", "n_kv", "head_dim", "qk_norm", "rope_theta", "block_q",
    "block_k"))
r_moe_ffn = jax.jit(r_moe.moe_ffn, static_argnames=("top_k",
                                                     "capacity_factor"))
r_mlp = jax.jit(r_layers.mlp, static_argnames=("gated", "act"))


def rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float()) if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def both(x: np.ndarray, dtype: str):
    """The same array as a jax and a torch tensor of ``dtype`` (both round
    the float32 values to nearest even)."""
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(x, np.float32)).to(td))


def made(shell: torch.nn.Module, seed: int):
    """Seeded float32 parameters for a port module built on ``meta``: the
    port's module and the reference's tree (nested dicts of the same
    values).  Weights are normal over sqrt(fan-in), as the reference's
    init draws them; norm scales are 1 plus noise."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name, spec in shell.state_dict().items():
        shape = tuple(spec.shape)
        if name.endswith("scale"):
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            value = rng.standard_normal(shape) * shape[-2] ** -0.5
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value.astype(np.float32))
    state = {k: torch.from_numpy(np.array(v)) for k, v in _flatten(tree)}
    shell.load_state_dict(state, assign=True)
    return shell, tree


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    scale = 1.0 + 0.1 * normal(1, (48,))
    jx, tx = both(normal(2, (3, 5, 48), 3.0), dtype)
    got = layers.rms_norm(layers.RMSNorm(torch.from_numpy(scale)), tx)
    want = r_layers.rms_norm({"scale": jnp.asarray(scale)}, jx)
    assert got.dtype == tx.dtype
    assert rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_norm(dtype):
    scale = 1.0 + 0.1 * normal(3, (16,))
    jx, tx = both(normal(4, (2, 7, 4, 16), 2.0), dtype)
    got = attn._head_norm(layers.RMSNorm(torch.from_numpy(scale)), tx)
    want = r_attn._head_norm({"scale": jnp.asarray(scale)}, jx)
    assert got.dtype == tx.dtype
    assert rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    p, ref = made(layers.init_dense(None, 32, 24), 5)
    jx, tx = both(normal(5, (2, 6, 32)), dtype)
    got = layers.dense(p, tx)
    assert got.dtype == tx.dtype
    assert rel(got, r_layers.dense(ref, jx)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (True, "gelu")])
def test_mlp(gated, act, dtype):
    p, ref = made(layers.init_mlp(None, 32, 64, gated), 6)
    jx, tx = both(normal(6, (2, 9, 32), 2.0), dtype)
    got = layers.mlp(p, tx, gated=gated, act=act)
    want = r_mlp(ref, jx, gated=gated, act=act)
    assert rel(got, want) <= TOL[dtype]


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; torch's exact gelu would miss the
    float32 bar by orders of magnitude."""
    x = normal(7, (4096,), 3.0)
    want = jax.nn.gelu(jnp.asarray(x))
    tx = torch.from_numpy(x)
    assert rel(layers.ACTS["gelu"](tx), want) <= 1e-6
    assert rel(F.gelu(tx), want) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta, dtype):
    positions = np.arange(3, 67)
    cos, sin = layers.rope_table(torch.from_numpy(positions), 32, theta)
    rcos, rsin = r_layers.rope_table(jnp.asarray(positions), 32, theta)
    assert cos.dtype == torch.float32 and cos.shape == (64, 16)
    assert rel(cos, rcos) <= 1e-5 and rel(sin, rsin) <= 1e-5
    jx, tx = both(normal(8, (2, 64, 3, 32)), dtype)
    got = layers.apply_rope(tx, cos, sin)
    want = r_layers.apply_rope(jx, rcos, rsin)
    assert got.dtype == tx.dtype
    assert rel(got, want) <= TOL[dtype]


def test_rope_splits_heads_in_half():
    """Position 1 rotates the pair (d, d + D/2), not (2d, 2d + 1)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    cos, sin = layers.rope_table(torch.tensor([1]), 8)
    y = layers.apply_rope(x, cos, sin)
    assert y[..., 4] == pytest.approx(float(np.sin(1.0)))
    assert y[..., 1] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_unembed(dtype):
    p, ref = made(layers.init_embedding(None, 50, 16), 9)
    tokens = np.random.default_rng(9).integers(0, 50, (3, 11)).astype(np.int32)
    jd, td = DTYPES[dtype]
    got = layers.embed(p, torch.from_numpy(tokens), td)
    want = r_layers.embed(ref, jnp.asarray(tokens), jd)
    assert got.dtype == td and rel(got, want) == 0.0
    jx, tx = both(normal(10, (3, 11, 16)), dtype)
    assert rel(layers.unembed(p, tx), r_layers.unembed(ref, jx)) <= TOL[dtype]


# --------------------------------------------------------------------------
# blocked attention
# --------------------------------------------------------------------------
def _qkv(seed, b, sq, skv, h, kh, d, dtype):
    q = normal(seed, (b, sq, h, d))
    k = normal(seed + 1, (b, skv, kh, d))
    v = normal(seed + 2, (b, skv, kh, d))
    return [both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,h,kh,causal,window", [
    (64, 64, 4, 4, True, 0),
    (64, 64, 8, 2, True, 0),     # GQA
    (33, 33, 4, 2, True, 0),     # ragged against the block size
    (64, 64, 4, 4, True, 16),    # sliding window
    (17, 64, 4, 4, False, 0),    # cross-attention shape
])
def test_blocked_attention(sq, skv, h, kh, causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(11, 2, sq, skv, h, kh, 16, dtype)
    got = attn.blocked_attention(tq, tk, tv, causal=causal, window=window,
                                 block_q=16, block_k=16)
    want = r_attn.blocked_attention(jq, jk, jv, causal=causal,
                                    window=window, block_q=16, block_k=16)
    assert got.dtype == tq.dtype and got.shape == (2, sq, h, 16)
    assert rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("is_global", [False, True])
def test_blocked_attention_is_global(is_global):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(12, 1, 32, 32, 2, 2, 8, "float32")
    got = attn.blocked_attention(tq, tk, tv, window=8, is_global=is_global,
                                 block_q=8, block_k=8)
    want = r_attn.blocked_attention(jq, jk, jv, window=8,
                                    is_global=jnp.asarray(is_global),
                                    block_q=8, block_k=8)
    assert rel(got, want) <= 1e-5
    window_only = attn.blocked_attention(tq, tk, tv, window=8, block_q=8,
                                         block_k=8)
    assert torch.equal(got, window_only) is (not is_global)


@pytest.mark.parametrize("sq,q_offset,kv_len", [
    (40, 0, 29),         # blocked: the cache tail masked
    (3, 21, 24),         # dense branch (sq <= 4), decode-like offset
    (1, 9, 10),          # one token
    (4, 0, None),        # dense branch with no cache length
])
def test_blocked_attention_kv_len_and_dense_branch(sq, q_offset, kv_len):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(13, 2, sq, 48, 8, 2, 16, "float32")
    got = attn.blocked_attention(tq, tk, tv, q_offset=q_offset, window=12,
                                 is_global=False, kv_len=kv_len, block_q=16,
                                 block_k=16)
    want = r_attn.blocked_attention(
        jq, jk, jv, q_offset=q_offset, window=12,
        is_global=jnp.asarray(False),
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        block_q=16, block_k=16)
    assert rel(got, want) <= 1e-5


def test_fully_masked_rows_are_finite():
    """kv_len 0 masks every key: the reference's finite -1e30 and its
    max(l, 1e-30) give finite rows, and the port gives the same."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(14, 1, 24, 24, 2, 1, 8, "float32")
    got = attn.blocked_attention(tq, tk, tv, kv_len=0, block_q=8, block_k=8)
    want = r_attn.blocked_attention(jq, jk, jv, kv_len=jnp.asarray(0),
                                    block_q=8, block_k=8)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= 1e-5


# --------------------------------------------------------------------------
# the attention layer and its cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_prefill_then_decode(qk_norm, dtype):
    d, h, kh, hd, smax = 32, 4, 2, 8, 24
    p, ref = made(attn.init_attention(None, d, h, kh, hd, qk_norm), 15)
    jx, tx = both(normal(15, (2, 10, d)), dtype)
    jd, td = DTYPES[dtype]
    kw = dict(n_heads=h, n_kv=kh, head_dim=hd, qk_norm=qk_norm,
              rope_theta=1e6, block_q=8, block_k=8)
    full, _ = attn.attention(p, tx, positions=torch.arange(10), **kw)
    rfull, _ = r_attention(ref, jx, positions=jnp.arange(10), **kw)
    assert rel(full, rfull) <= TOL[dtype]

    cache = {"k": torch.zeros((2, smax, kh, hd), dtype=td),
             "v": torch.zeros((2, smax, kh, hd), dtype=td)}
    rcache = {"k": jnp.zeros((2, smax, kh, hd), jd),
              "v": jnp.zeros((2, smax, kh, hd), jd)}
    y0, cache = attn.attention(p, tx[:, :7], positions=torch.arange(7),
                               cache=cache, kv_len=0, **kw)
    ry0, rcache = r_attention(ref, jx[:, :7], positions=jnp.arange(7),
                                   cache=rcache, kv_len=jnp.asarray(0), **kw)
    assert rel(y0, ry0) <= TOL[dtype]
    for t in (7, 8):
        y, cache = attn.attention(p, tx[:, t:t + 1],
                                  positions=torch.arange(t, t + 1),
                                  cache=cache, kv_len=t, **kw)
        ry, rcache = r_attention(ref, jx[:, t:t + 1],
                                      positions=jnp.arange(t, t + 1),
                                      cache=rcache, kv_len=jnp.asarray(t),
                                      **kw)
        assert rel(y, ry) <= TOL[dtype]
    for name in ("k", "v"):
        assert cache[name].dtype == td
        assert rel(cache[name], rcache[name]) <= TOL[dtype]


def test_cache_write_clamps_like_dynamic_update_slice():
    """A write past the end lands at Smax - s, as the reference's
    ``dynamic_update_slice`` clamps its start."""
    buf = torch.zeros(1, 6, 1, 1)
    attn._write(buf, torch.ones(1, 3, 1, 1), 5)
    want = jax.lax.dynamic_update_slice_in_dim(
        jnp.zeros((1, 6, 1, 1)), jnp.ones((1, 3, 1, 1)), 5, axis=1)
    assert np.array_equal(buf.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn(n_shared, dtype):
    """Capacity factor 0.5 drops tokens (checked): the cumsum slots, the
    trash row and the sum over experts must be the reference's."""
    d, dff, e, k = 16, 32, 4, 2
    p, ref = made(moe.init_moe(None, d, dff, e, n_shared, 24), 16)
    jx, tx = both(normal(16, (2, 12, d)), dtype)
    got, aux = moe.moe_ffn(p, tx, top_k=k, capacity_factor=0.5)
    want, raux = r_moe_ffn(ref, jx, top_k=k, capacity_factor=0.5)
    assert got.dtype == tx.dtype
    assert rel(got, want) <= TOL[dtype]
    assert abs(float(aux) - float(raux)) <= 1e-5 * abs(float(raux))
    # tokens were dropped: some expert got more than its capacity
    top_idx, _, _ = moe._route(p.router.w, tx.reshape(24, d), k)
    cap = int(24 * k / e * 0.5)
    assert torch.bincount(top_idx.flatten(), minlength=e).max() > cap
