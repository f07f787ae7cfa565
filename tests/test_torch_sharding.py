"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference package's (``repro.models.sharding``), with no ranks.

* ``param_specs`` of every leaf of all ten configs at full size, on stub
  meshes of shape (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1): the
  port's ``meta`` shell against the reference's ``jax.eval_shape`` of
  ``init_params``, names matched by ``convert.reference_key`` and the
  reference's stack entries dropped.  A stub mesh is enough: the
  reference's ``_fit_to_mesh`` reads only ``mesh.shape`` (and ``Sharder``
  ``axis_names``).
* ``Sharder.kv_cache_spec`` against the reference's over a grid of cache
  shapes and axis choices on the same stubs.
* ``placements``: a spec as DTensor placements; a ``Sharder`` without a
  mesh is the identity.
"""

from __future__ import annotations

import itertools

import jax
import pytest
import torch

from repro.configs import base as r_base
from repro.models import sharding as r_sharding
from repro.models.model import Model as RModel
from repro_torch.configs import base
from repro_torch.models import sharding
from repro_torch.models.convert import reference_key
from repro_torch.models.model import Model

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "gemma3-27b",
         "starcoder2-7b", "qwen3-1.7b", "internlm2-20b",
         "llama-3.2-vision-90b", "xlstm-350m", "hymba-1.5b",
         "musicgen-medium"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


class StubMesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


_SPECS: dict = {}


def _specs(arch: str):
    """(the port's meta shell, the reference's parameter shapes),
    cached per config."""
    if arch not in _SPECS:
        shell = Model(base.get_config(arch), device="cpu")._shell()
        shapes = jax.eval_shape(RModel(r_base.get_config(arch)).init_params,
                                jax.random.PRNGKey(0))
        _SPECS[arch] = (shell, shapes)
    return _SPECS[arch]


def _norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis name (a ``PartitionSpec``
    prints ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, r_sharding.P))[0]
    return {"/".join(r_sharding._key_str(k) for k in kp): v
            for kp, v in flat}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_are_the_references(arch, mesh):
    stub = StubMesh(*MESHES[mesh])
    shell, shapes = _specs(arch)
    want = _flat(r_sharding.param_specs(shapes, stub))
    got = sharding.param_specs(shell, stub)
    seen = set()
    for name, spec in got.items():
        key, index = reference_key(name)
        seen.add(key)
        ref = _norm(tuple(want[key])[len(index):])
        assert _norm(spec) == ref, (name, spec, ref)
    assert seen == set(want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_shard_the_expert_tables(mesh):
    """The trap of matching ``moe/up`` against a dotted per-layer name:
    every expert table keeps its expert axis on ``model``."""
    stub = StubMesh(*MESHES[mesh])
    shell, _ = _specs("granite-moe-1b-a400m")
    got = sharding.param_specs(shell, stub)
    tables = {k: v for k, v in got.items()
              if k.rsplit(".", 1)[-1] in ("up", "gate", "down")
              and ".moe." in k and ".shared." not in k}
    assert len(tables) == 3 * 24
    for name, spec in tables.items():
        assert spec[0] == "model", (name, spec)


def _kv_grid():
    shapes = [(4, 8, 32, 8, 16), (4, 1, 32, 8, 16), (2, 3, 64, 2, 16),
              (4, 16, 32, 16, 8), (1, 2, 48, 1, 8), (2, 32, 4096, 8, 128),
              (1, 1, 32768, 4, 128), (2, 128, 32768, 8, 128)]
    axes = [dict(), dict(head_axis=None),
            dict(batch_axis=1, seq_axis=1, head_axis=None)]
    vlm = [((2, 4, 8, 64, 8, 16), dict(batch_axis=2, seq_axis=3,
                                        head_axis=4)),
           ((2, 4, 1, 64, 2, 16), dict(batch_axis=2, seq_axis=3,
                                        head_axis=4))]
    return [(s, a) for s, a in itertools.product(shapes, axes)] + vlm


@pytest.mark.parametrize("mesh", list(MESHES))
def test_kv_cache_spec_is_the_references(mesh):
    stub = StubMesh(*MESHES[mesh])
    mine, ref = sharding.Sharder(stub), r_sharding.Sharder(stub)
    assert mine.dp == ref.dp and mine.dp_size == ref.dp_size
    for shape, axes in _kv_grid():
        want = tuple(ref.kv_cache_spec(shape, **axes))
        got = mine.kv_cache_spec(shape, **axes)
        assert _norm(got) == _norm(want) + (None,) * (len(got) - len(want)), \
            (shape, axes, got, want)


def test_rule_is_the_references_on_paths():
    """``_rule`` line for line, on every path and rank the reference's
    branches distinguish."""
    paths = ["embed/table", "lm_head/table", "meta_tokens",
             "layers/moe/up", "layers/moe/gate", "layers/moe/down",
             "layers/moe/router/w", "layers/attn/wq/w", "layers/attn/wo/w",
             "layers/mlp/up/w", "layers/mlp/down/w", "layers/mlp/gate/w",
             "layers/attn/wdkv/w", "layers/mamba/w_dt/w",
             "layers/mamba/wx_bc/w", "layers/mamba/conv/w",
             "units/slstm/rh/w", "units/slstm/wx/w", "units/mlstm/in_up/w",
             "layers/mamba/out_proj/w", "layers/attn/wuk/w",
             "final_norm/scale", "layers/mamba/a_log", "other/w"]
    for path in paths:
        for nd in range(1, 5):
            shape = (8,) * nd
            assert sharding._rule(path, shape) == \
                tuple(r_sharding._rule(path, shape)), (path, nd)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    stub = StubMesh((2, 4, 4), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), stub) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), stub) == [Replicate()] * 3
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), stub)
    with pytest.raises(ValueError):
        sharding.placements(("model", "model"), stub)


def test_sharder_without_a_mesh_is_the_identity():
    sh = sharding.Sharder()
    x = torch.ones(4, 6, 8)
    assert sh.dp_size == 1
    for fn in (sh.batch, sh.acts, sh.heads, sh.logits):
        assert fn(x) is x
    assert sh(x, "data") is x and sh.kv_cache(x) is x
    assert sh.kv_cache_spec((2, 4, 8, 2, 16)) == ()


def test_sharder_puts_pod_first():
    stub = StubMesh((2, 16, 16), ("pod", "data", "model"))
    sh = sharding.Sharder(stub)
    assert sh.dp == ("pod", "data") and sh.dp_size == 32
    assert sh.dp == r_sharding.Sharder(stub).dp
