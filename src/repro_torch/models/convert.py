"""Carry the reference package's parameters over to the port.

``params_from_reference(model, tree)`` takes a parameter tree as the
reference's ``Model.init_params`` returns it, as nested dicts of numpy
arrays (layers stacked on a leading axis of ``n_layers``), and loads it
into the port's modules, so both packages compute with the same numbers.
vlm's ``units.self`` is stacked twice, ``(n_units, n_self, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import Model, Params

#: top-level subtrees whose leaves stack one entry per layer (or unit)
STACKED = ("layers", "dense_layers", "units")
#: subtrees of a stacked entry whose leaves stack a second time
SUBSTACKED = ("self",)


def _flatten(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, name + ".")
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
    shell = model._shell()
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
    return shell
