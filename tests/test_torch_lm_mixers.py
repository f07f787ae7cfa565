"""The port's recurrent mixers (``repro_torch.models.ssm``), MLA,
cross-attention and the scaled blocked attention
(``repro_torch.models.attention``) against the reference package's, on
the same inputs, and the reference's own self-consistency cases
(``tests/test_layers.py``: chunked against recurrent, streamed against
whole) on the port.

Inputs and parameters come from numpy with a fixed seed; the parameters
go to the reference as its nested dicts and to the port's modules (built
on ``meta`` by the port's ``init_*``) under the same names.  Tolerances
(rel-L2): 1e-5 in float32, where only the summation order differs; 2e-2
in bfloat16, where the two frameworks round intermediate products at
different points.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.models import attention as r_attn
from repro.models import ssm as r_ssm
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.convert import _flatten

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the reference's functions compiled whole (faster here than op by op)
r_conv1d = jax.jit(r_ssm.conv1d)
r_mlstm_sequence = jax.jit(r_ssm.mlstm_sequence, static_argnames=(
    "n_heads", "chunk", "return_state"))
r_mlstm_decode = jax.jit(r_ssm.mlstm_decode, static_argnames=("n_heads",))
r_slstm_sequence = jax.jit(r_ssm.slstm_sequence, static_argnames=("n_heads",))
r_mamba_mix = jax.jit(r_ssm.mamba_mix, static_argnames=("chunk",))
r_cross_attention = jax.jit(r_attn.cross_attention, static_argnames=(
    "n_heads", "n_kv", "head_dim", "block_q", "block_k"))
r_mla_attention = jax.jit(r_attn.mla_attention, static_argnames=(
    "n_heads", "kv_lora", "nope_dim", "rope_dim", "v_dim", "rope_theta",
    "block_q", "block_k"))


def rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def both(x: np.ndarray, dtype: str):
    """The same array as a jax and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(x, np.float32)).to(td))


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def made(shell: torch.nn.Module, seed: int):
    """Seeded float32 parameters for a port module built on ``meta``: the
    port's module and the reference's tree (nested dicts of the same
    values).  Matrices are normal over sqrt(fan-in), norm scales 1 plus
    noise, vectors (biases, gates, the skip) normal over 2."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name, spec in shell.state_dict().items():
        shape = tuple(spec.shape)
        if name.endswith("scale"):
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            value = 0.5 * rng.standard_normal(shape)
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


def states_rel(got: dict, want: dict) -> dict:
    return {k: rel(got[k], want[k]) for k in want}


# --------------------------------------------------------------------------
# conv1d
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d(with_state, dtype):
    p, ref = made(ssm.init_conv1d(None, 12, 4), 1)
    jx, tx = both(normal(2, (2, 9, 12)), dtype)
    js = ts = None
    if with_state:
        js, ts = both(normal(3, (2, 3, 12)), dtype)
    got, state = ssm.conv1d(p, tx, ts)
    want, rstate = r_conv1d(ref, jx, js)
    assert got.dtype == tx.dtype and state.shape == (2, 3, 12)
    assert rel(got, want) <= TOL[dtype]
    assert rel(state, rstate) == 0.0


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
D, H = 16, 2


def _mlstm(seed=4):
    return made(ssm.init_mlstm(None, D, H, conv_k=4), seed)


def _mlstm_state(seed):
    """A nonzero decode state of the reference's layout, as numpy."""
    di, dh = 2 * D, D
    return {"c": normal(seed, (2, H, dh, dh), 0.3),
            "n": normal(seed + 1, (2, H, dh), 0.3),
            "m": normal(seed + 2, (2, H)),
            "conv": normal(seed + 3, (2, 3, di))}


def _state_pair(state: dict):
    return ({k: jnp.asarray(v) for k, v in state.items()},
            {k: torch.from_numpy(v) for k, v in state.items()})


@pytest.mark.parametrize("chunk,s,seeded", [
    (4, 11, False),      # ragged against the chunk: the padded tail
    (4, 12, True),       # three chunks from a seeded state
    (128, 12, True),     # one chunk
])
def test_mlstm_sequence(chunk, s, seeded):
    p, ref = _mlstm()
    jx, tx = both(normal(5, (2, s, D), 0.5), "float32")
    jst, tst = _state_pair(_mlstm_state(6)) if seeded else (None, None)
    got, state = ssm.mlstm_sequence(p, tx, H, chunk=chunk, state=tst,
                                    return_state=True)
    want, rstate = r_mlstm_sequence(ref, jx, n_heads=H, chunk=chunk,
                                    state=jst, return_state=True)
    assert rel(got, want) <= 1e-5
    assert set(state) == set(rstate) == {"c", "n", "m", "conv"}
    assert all(v.dtype == torch.float32 for v in state.values())
    assert max(states_rel(state, rstate).values()) <= 1e-5
    plain = ssm.mlstm_sequence(p, tx, H, chunk=chunk, state=tst)
    assert torch.equal(plain, got)


def test_mlstm_sequence_bf16():
    p, ref = _mlstm()
    jx, tx = both(normal(7, (2, 12, D), 0.5), "bfloat16")
    got = ssm.mlstm_sequence(p, tx, H, chunk=4)
    want = r_mlstm_sequence(ref, jx, n_heads=H, chunk=4)
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode(dtype):
    p, ref = _mlstm()
    jx, tx = both(normal(8, (2, 1, D), 0.5), dtype)
    jst, tst = _state_pair(_mlstm_state(9))
    got, state = ssm.mlstm_decode(p, tx, tst, H)
    want, rstate = r_mlstm_decode(ref, jx, jst, n_heads=H)
    assert got.dtype == tx.dtype and state["conv"].dtype == tx.dtype
    assert rel(got, want) <= TOL[dtype]
    assert max(states_rel(state, rstate).values()) <= TOL[dtype]


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_sequence_streamed(dtype):
    """Two halves, the second from the first's state, against the
    reference's two halves; the states too."""
    p, ref = made(ssm.init_slstm(None, D, 4), 10)
    jx, tx = both(normal(11, (2, 10, D), 0.5), dtype)
    y1, st = ssm.slstm_sequence(p, tx[:, :5], 4)
    y2, st = ssm.slstm_sequence(p, tx[:, 5:], 4, state=st)
    r1, rst = r_slstm_sequence(ref, jx[:, :5], n_heads=4)
    r2, rst = r_slstm_sequence(ref, jx[:, 5:], n_heads=4, state=rst)
    assert y1.dtype == tx.dtype
    assert rel(torch.cat([y1, y2], 1), jnp.concatenate([r1, r2], 1)) \
        <= TOL[dtype]
    assert set(st) == {"c", "n", "h", "m"}
    assert max(states_rel(st, rst).values()) <= TOL[dtype]


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,s", [(4, 11), (128, 9), (16, 64)])
def test_mamba_mix_sequence(chunk, s, dtype):
    p, ref = made(ssm.init_mamba(None, 12, 24, state=8, conv_k=4), 12)
    jx, tx = both(normal(13, (2, s, 12), 0.5), dtype)
    got, (conv, h) = ssm.mamba_mix(p, tx, chunk=chunk)
    want, (rconv, rh) = r_mamba_mix(ref, jx, chunk=chunk)
    assert got.dtype == tx.dtype and h.dtype == torch.float32
    assert rel(got, want) <= TOL[dtype]
    assert rel(conv, rconv) <= TOL[dtype] and rel(h, rh) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mix_decode(dtype):
    p, ref = made(ssm.init_mamba(None, 12, 24, state=8, conv_k=4), 14)
    jx, tx = both(normal(15, (2, 1, 12), 0.5), dtype)
    jc, tc = both(normal(16, (2, 3, 24)), dtype)
    h0 = normal(17, (2, 24, 8))
    got, (conv, h) = ssm.mamba_mix(p, tx, tc, torch.from_numpy(h0))
    want, (rconv, rh) = r_mamba_mix(ref, jx, jc, jnp.asarray(h0))
    assert rel(got, want) <= TOL[dtype]
    assert rel(conv, rconv) <= TOL[dtype] and rel(h, rh) <= TOL[dtype]


def test_mamba_scan_is_the_sequential_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step, in
    float64, over a chunk that is not a power of two of the length."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 37, 3, 4), generator=g, dtype=torch.float64)
    b = torch.randn((2, 37, 3, 4), generator=g, dtype=torch.float64)
    h0 = torch.randn((2, 3, 4), generator=g, dtype=torch.float64)
    hs, h_fin = ssm._mamba_scan(a, b, h0, chunk=16)
    h, want = h0, []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert torch.allclose(hs, torch.stack(want, 1), rtol=1e-12, atol=1e-12)
    assert torch.allclose(h_fin, want[-1], rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# cross-attention, MLA, the softmax scale
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention(dtype):
    d, h, kh, hd = 32, 4, 2, 8
    p, ref = made(attn.init_cross_attention(None, d, h, kh, hd), 18)
    jx, tx = both(normal(19, (2, 7, d)), dtype)
    ji, ti = both(normal(20, (2, 21, d)), dtype)
    kw = dict(n_heads=h, n_kv=kh, head_dim=hd, block_q=4, block_k=8)
    got = attn.cross_attention(p, tx, ti, **kw)
    want = r_cross_attention(ref, jx, ji, **kw)
    assert got.dtype == tx.dtype and rel(got, want) <= TOL[dtype]
    one = attn.cross_attention(p, tx[:, :1], ti, **kw)     # a decode step
    assert rel(one, r_cross_attention(ref, jx[:, :1], ji, **kw)) \
        <= TOL[dtype]


MLA_DIMS = dict(kv_lora=16, nope_dim=8, rope_dim=4, v_dim=8)


def _mla(seed=21):
    return made(attn.init_mla(None, 32, 4, **MLA_DIMS), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decompressed_forward(dtype):
    p, ref = _mla()
    jx, tx = both(normal(22, (2, 13, 32)), dtype)
    kw = dict(n_heads=4, block_q=8, block_k=8, rope_theta=1e4, **MLA_DIMS)
    got, none = attn.mla_attention(p, tx, positions=torch.arange(13), **kw)
    want, _ = r_mla_attention(ref, jx, positions=jnp.arange(13), **kw)
    assert none is None and got.dtype == tx.dtype
    assert rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_prefill_and_decode(dtype):
    """A prefill of 9 into a cache of 16 (absorbed, blocked over the whole
    cache) and two decode steps: outputs and the latent cache."""
    p, ref = _mla()
    jx, tx = both(normal(23, (2, 11, 32)), dtype)
    jd, td = DTYPES[dtype]
    kw = dict(n_heads=4, block_q=8, block_k=8, rope_theta=1e4, **MLA_DIMS)
    cache = {"c_kv": torch.zeros((2, 16, 16), dtype=td),
             "k_rope": torch.zeros((2, 16, 4), dtype=td)}
    rcache = {"c_kv": jnp.zeros((2, 16, 16), jd),
              "k_rope": jnp.zeros((2, 16, 4), jd)}
    y, cache = attn.mla_attention(p, tx[:, :9], positions=torch.arange(9),
                                  cache=cache, kv_len=0, **kw)
    ry, rcache = r_mla_attention(ref, jx[:, :9], positions=jnp.arange(9),
                                 cache=rcache, kv_len=jnp.asarray(0), **kw)
    assert rel(y, ry) <= TOL[dtype]
    for t in (9, 10):
        y, cache = attn.mla_attention(p, tx[:, t:t + 1],
                                      positions=torch.arange(t, t + 1),
                                      cache=cache, kv_len=t, **kw)
        ry, rcache = r_mla_attention(ref, jx[:, t:t + 1],
                                     positions=jnp.arange(t, t + 1),
                                     cache=rcache, kv_len=jnp.asarray(t),
                                     **kw)
        assert rel(y, ry) <= TOL[dtype]
    for name in ("c_kv", "k_rope"):
        assert cache[name].dtype == td
        assert rel(cache[name], rcache[name]) <= TOL[dtype]


@pytest.mark.parametrize("sq", [24, 3])
def test_blocked_attention_softmax_scale(sq):
    """An explicit scale in the blocked and the dense branch; v wider
    than k, as MLA's absorbed form has it."""
    q = normal(24, (2, sq, 4, 12))
    k = normal(25, (2, 24, 1, 12))
    v = normal(26, (2, 24, 1, 20))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "float32") for a in (q, k, v))
    got = attn.blocked_attention(tq, tk, tv, q_offset=24 - sq, kv_len=24,
                                 block_q=8, block_k=8, softmax_scale=0.37)
    want = r_attn.blocked_attention(jq, jk, jv, q_offset=24 - sq,
                                    kv_len=jnp.asarray(24), block_q=8,
                                    block_k=8, softmax_scale=0.37)
    assert got.shape == (2, sq, 4, 20) and rel(got, want) <= 1e-5
    default = attn.blocked_attention(tq, tk, tv, q_offset=24 - sq,
                                     block_q=8, block_k=8)
    assert rel(default, got) > 1e-3


# --------------------------------------------------------------------------
# the reference's self-consistency cases, on the port
# --------------------------------------------------------------------------
def test_mla_decode_matches_prefill():
    p, _ = _mla(27)
    x = torch.from_numpy(normal(28, (2, 9, 32)))
    kw = dict(n_heads=4, block_q=8, block_k=8, **MLA_DIMS)
    full, _ = attn.mla_attention(p, x, positions=torch.arange(9), **kw)
    cache = {"c_kv": torch.zeros((2, 16, 16)),
             "k_rope": torch.zeros((2, 16, 4))}
    _, cache = attn.mla_attention(p, x[:, :8], positions=torch.arange(8),
                                  cache=cache, kv_len=0, **kw)
    y, _ = attn.mla_attention(p, x[:, 8:9], positions=torch.arange(8, 9),
                              cache=cache, kv_len=8, **kw)
    torch.testing.assert_close(y, full[:, 8:9], rtol=2e-3, atol=2e-3)


def test_conv1d_causal_and_decode():
    p, _ = made(ssm.init_conv1d(None, 6, 4), 29)
    x = torch.from_numpy(normal(30, (2, 10, 6)))
    y_full, _ = ssm.conv1d(p, x)
    state = torch.zeros((2, 3, 6))
    outs = []
    for t in range(10):
        y, state = ssm.conv1d(p, x[:, t:t + 1], state)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), y_full, rtol=1e-4,
                               atol=1e-5)


def test_mlstm_chunked_matches_decode():
    p, _ = _mlstm(31)
    x = torch.from_numpy(normal(32, (2, 12, D), 0.5))
    y_seq = ssm.mlstm_sequence(p, x, H, chunk=4)
    cache = ssm.mlstm_decode_init(2, H, 2 * D, 4)
    outs = []
    for t in range(12):
        y, cache = ssm.mlstm_decode(p, x[:, t:t + 1], cache, H)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), y_seq, rtol=5e-3,
                               atol=5e-3)


def test_mlstm_chunk_invariance():
    p, _ = _mlstm(33)
    x = torch.from_numpy(normal(34, (1, 16, D), 0.5))
    torch.testing.assert_close(ssm.mlstm_sequence(p, x, H, chunk=4),
                               ssm.mlstm_sequence(p, x, H, chunk=16),
                               rtol=3e-3, atol=3e-3)


def test_slstm_runs_and_streams():
    p, _ = made(ssm.init_slstm(None, D, 4), 35)
    x = torch.from_numpy(normal(36, (2, 10, D), 0.5))
    y_full, _ = ssm.slstm_sequence(p, x, 4)
    assert y_full.shape == (2, 10, D)
    y1, st = ssm.slstm_sequence(p, x[:, :5], 4)
    y2, _ = ssm.slstm_sequence(p, x[:, 5:], 4, state=st)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=2e-3,
                               atol=2e-3)


def test_mamba_chunked_matches_decode():
    p, _ = made(ssm.init_mamba(None, 12, 24, state=8, conv_k=4), 37)
    x = torch.from_numpy(normal(38, (2, 9, 12), 0.5))
    y_full, _ = ssm.mamba_mix(p, x, chunk=4)
    conv_state, ssm_state = torch.zeros((2, 3, 24)), torch.zeros((2, 24, 8))
    outs = []
    for t in range(9):
        y, (conv_state, ssm_state) = ssm.mamba_mix(p, x[:, t:t + 1],
                                                   conv_state, ssm_state)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), y_full, rtol=5e-3,
                               atol=5e-3)


def test_init_matches_the_reference_structure():
    """The port's init_* give the reference's names, shapes and fixed
    values (biases, a_log, d_skip)."""
    fixed = ("wif.b", "bias", "w_dt.b", "a_log", "d_skip")

    def ref(init, *dims, **kw):
        """Shapes of every leaf; values of the fixed vectors (the random
        draws are dead code under jit)."""
        def vectors(key):
            tree, out = init(key, *dims, **kw), {}
            for name in fixed:
                node = tree
                for part in name.split("."):
                    node = node.get(part, {})
                if not isinstance(node, dict):
                    out[name] = node
            return out
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda k: init(k, *dims, **kw), key)
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes), \
            jax.jit(vectors)(key)

    g = torch.Generator().manual_seed(0)
    pairs = [(ssm.init_mlstm(g, D, H), ref(r_ssm.init_mlstm, D, H)),
             (ssm.init_slstm(g, D, 4), ref(r_ssm.init_slstm, D, 4)),
             (ssm.init_mamba(g, 12, 24, 8), ref(r_ssm.init_mamba, 12, 24, 8)),
             (attn.init_mla(g, 32, 4, **MLA_DIMS),
              ref(r_attn.init_mla, 32, 4, **MLA_DIMS)),
             (attn.init_cross_attention(g, 32, 4, 2, 8),
              ref(r_attn.init_cross_attention, 32, 4, 2, 8))]
    for port, (tree, values) in pairs:
        state, want = port.state_dict(), dict(_flatten(tree))
        assert set(state) == set(want)
        for name, t in state.items():
            assert tuple(t.shape) == want[name].shape
            assert t.dtype == torch.float32
            if name in fixed:
                np.testing.assert_allclose(t.numpy(), values[name],
                                           rtol=1e-6)
