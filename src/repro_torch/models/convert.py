"""Carry parameters between the reference package's layout and the port's.

``params_from_reference(model, tree)`` takes a parameter tree as the
reference's ``Model.init_params`` returns it, as nested dicts of numpy
arrays (layers stacked on a leading axis of ``n_layers``), and loads it
into the port's modules, so both packages compute with the same numbers.
vlm's ``units.self`` is stacked twice, ``(n_units, n_self, ...)``.

The other way, ``params_to_reference`` stacks the port's per-layer tensors
(a ``Params`` module, or any mapping of state-dict names to tensors: a
gradient, an optimizer moment) back into that nested tree, and
``opt_state_to_reference`` / ``opt_state_from_reference`` carry AdamW's
``{"m", "v", "step"}``.  ``reference_key`` is the one map between the two
namings: the checkpoint writer and the decay mask use it too.

A sharded model (one on a mesh) takes the same trees: the reference's
arrays are placed by ``param_specs`` (each rank keeps its slice), and a
DTensor leaf is gathered whole (``full_tensor``, a collective every rank
joins) on its way back to a host array.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .model import Model, Params
from .sharding import is_dtensor

#: top-level subtrees whose leaves stack one entry per layer (or unit)
STACKED = ("layers", "dense_layers", "units")
#: subtrees of a stacked entry whose leaves stack a second time
SUBSTACKED = ("self",)


def _flatten(tree: dict, prefix: str = "", sep: str = "."):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + sep, sep)
        else:
            yield name, np.asarray(value)


def flat_reference(tree: dict) -> dict[str, np.ndarray]:
    """The tree's leaves under the port's state-dict names: each stacked
    leaf split into one entry per layer (``layers.ln1.scale`` of shape
    (L, d) becomes ``layers.0.ln1.scale`` ... ``layers.{L-1}.ln1.scale``;
    ``units.self.attn.wq.w`` of shape (U, N, ...) becomes
    ``units.{u}.self.{i}.attn.wq.w``)."""
    flat: dict[str, np.ndarray] = {}
    for name, arr in _flatten(tree):
        top, _, rest = name.partition(".")
        if top not in STACKED:
            flat[name] = arr
            continue
        sub, _, tail = rest.partition(".")
        for i in range(arr.shape[0]):
            if sub in SUBSTACKED:
                for j in range(arr.shape[1]):
                    flat[f"{top}.{i}.{sub}.{j}.{tail}"] = arr[i, j]
            else:
                flat[f"{top}.{i}.{rest}"] = arr[i]
    return flat


def params_from_reference(model: Model, tree: dict) -> Params:
    """The reference tree as the port's parameters on the model's device.
    Every leaf must be there with the port's shape and dtype; a missing,
    extra or misshapen leaf raises ``ValueError``."""
    flat = flat_reference(tree)
    shell = model.abstract_params()
    want = shell.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"extra {extra}")
    state = {}
    for name, spec in want.items():
        t = torch.from_numpy(np.array(flat[name]))
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the port "
                             f"wants {tuple(spec.shape)} {spec.dtype}")
        state[name] = t.to(model.device)
    shell.load_state_dict(state, assign=True)
    return model.shard(shell)


def reference_key(name: str) -> tuple[str, tuple[int, ...]]:
    """The reference's ``/``-joined path of a port state-dict name, and the
    index of the name's entry in that stacked leaf:
    ``layers.3.attn.wq.w`` -> (``layers/attn/wq/w``, (3,));
    ``units.1.self.2.ln1.scale`` -> (``units/self/ln1/scale``, (1, 2));
    ``final_norm.scale`` -> (``final_norm/scale``, ())."""
    parts = name.split(".")
    index: list[int] = []
    if parts[0] in STACKED and len(parts) > 1 and parts[1].isdigit():
        index.append(int(parts.pop(1)))
        if len(parts) > 2 and parts[1] in SUBSTACKED and parts[2].isdigit():
            index.append(int(parts.pop(2)))
    return "/".join(parts), tuple(index)


def named_tensors(tree) -> dict[str, torch.Tensor]:
    """A module's parameters, or a nested dict's leaves, by dotted name
    (the module's own ``Parameter`` objects, so updates land in it)."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    out: dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update({f"{key}.{k}": v
                        for k, v in named_tensors(value).items()})
        else:
            out[key] = value
    return out


def host_array(t) -> np.ndarray:
    """A copy of a tensor as a numpy array on the host.  numpy has no
    bfloat16: a bf16 tensor becomes its raw 2-byte values (dtype
    ``|V2``), the bytes the reference writes for a ``jnp.bfloat16``
    leaf."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)  # never a view of the live tensor
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def reference_table(tree) -> dict[str, np.ndarray]:
    """The leaves of ``tree`` (see ``named_tensors``) as host arrays under
    the reference's ``/``-joined paths, each stacked leaf rebuilt from its
    per-layer entries, in the order the reference flattens its tree
    (dict keys sorted at every level)."""
    groups: dict[str, dict[tuple, np.ndarray]] = {}
    for name, t in named_tensors(tree).items():
        key, index = reference_key(name)
        groups.setdefault(key, {})[index] = host_array(t)
    table = {}
    for key in sorted(groups, key=lambda k: k.split("/")):
        entries = groups[key]
        if list(entries) == [()]:
            table[key] = entries[()]
            continue
        shape = tuple(max(i[a] for i in entries) + 1
                      for a in range(len(next(iter(entries)))))
        if len(entries) != int(np.prod(shape)):
            raise ValueError(f"{key}: entries {sorted(entries)} do not fill "
                             f"a stack of {shape}")
        first = next(iter(entries.values()))
        arr = np.empty(shape + first.shape, first.dtype)
        for index, value in entries.items():
            arr[index] = value
        table[key] = arr
    return table


def _nest(table: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, value in table.items():
        *path, leaf = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def params_to_reference(params) -> dict:
    """The inverse of ``flat_reference``: the port's parameters (or any
    mapping of their state-dict names to tensors) as the reference's
    nested tree of numpy arrays, layers stacked."""
    return _nest(reference_table(params))


def opt_state_table(state: dict) -> dict[str, np.ndarray]:
    """AdamW's state ``{"m", "v", "step"}`` (moments keyed by state-dict
    names) as the reference's flat table: ``m/<path>``, ``step``,
    ``v/<path>``, in the reference's order."""
    table = {f"{part}/{k}": a for part in ("m", "v")
             for k, a in reference_table(state[part]).items()}
    table["step"] = np.asarray(host_array(state["step"]), np.int32)
    return {k: table[k] for k in sorted(table, key=lambda k: k.split("/"))}


def opt_state_to_reference(state: dict) -> dict:
    """AdamW's state as the reference's tree: each moment nested and
    stacked like the parameters, ``step`` an int32 scalar."""
    return _nest(opt_state_table(state))


def from_table(table: Mapping[str, np.ndarray], name: str,
               like: torch.Tensor, prefix: str = "") -> torch.Tensor:
    """The entry of port name ``name`` from a reference table (keys
    ``prefix`` + the reference path), as a tensor of ``like``'s shape,
    dtype and device (and layout: a DTensor ``like`` gives a DTensor of
    its placements, each rank keeping its slice).  A 2-byte leaf read into
    a bf16 tensor is taken as raw bfloat16 values (``host_array``'s
    encoding)."""
    key, index = reference_key(name)
    if prefix + key not in table:
        raise KeyError(f"no {prefix + key} for {name}")
    arr = np.array(np.asarray(table[prefix + key])[index])  # a C copy
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch at {prefix + key}{list(index)}: "
                         f"{tuple(t.shape)}, want {tuple(like.shape)}")
    t = t.to(device=like.device, dtype=like.dtype)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return t


def opt_state_from_table(table: Mapping[str, np.ndarray],
                         template: dict) -> dict:
    """AdamW's state from the reference's flat table, shaped and placed
    like ``template`` (``init_opt_state`` of the parameters); ``step``
    stays on the host."""
    state = {part: {name: from_table(table, name, like, part + "/")
                    for name, like in template[part].items()}
             for part in ("m", "v")}
    state["step"] = torch.tensor(int(table["step"]), dtype=torch.int32)
    return state


def opt_state_from_reference(tree: dict, template: dict) -> dict:
    """The reference's AdamW tree as the port's state (see
    ``opt_state_from_table``)."""
    return opt_state_from_table(dict(_flatten(tree, sep="/")), template)
