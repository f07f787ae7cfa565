"""Checkpointing: atomic, layout-independent, resumable, in the reference
package's format.

A checkpoint is the reference's ``train/checkpoint.py`` layout, so that
one written by either package restores in the other:

    step_%08d/params.npz    the parameters under the reference's
                            ``/``-joined paths, per-layer tensors stacked
                            on a leading layer axis (``layers/attn/wq/w``)
    step_%08d/opt.npz       AdamW's moments under ``m/...`` and ``v/...``,
                            and ``step`` (int32)
    step_%08d/manifest.json ``{"step": N, **extra}``

- Arrays are host numpy copies of the tensors in their logical layout,
  never a device layout; a restore places them where the template's
  tensors live.
- Writes go to ``step_%08d.tmp`` and are ``os.replace``d into place, so a
  preempted writer never corrupts the latest checkpoint.
- ``keep`` rotates old checkpoints; ``save_async`` copies to the host
  first, then hands the file writes to a thread so the device keeps
  stepping.
- Mesh-independent, as the reference's: a sharded run's DTensor leaves
  are gathered whole on save (every rank joins) and rank 0 alone writes;
  on restore each leaf is laid out like the template's (``param_specs``
  on whatever mesh restores it), so a checkpoint crosses between meshes,
  the unsharded port and the reference.
- numpy has no bfloat16.  A bf16 tensor is written as its raw 2-byte
  values (dtype ``|V2``, which is also what the reference writes for a
  ``jnp.bfloat16`` leaf) and read back as bf16 wherever the template's
  tensor is bf16 (``models/convert.py``: ``host_array``, ``from_table``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn

from repro_torch.models.convert import (from_table, named_tensors,
                                        opt_state_from_table,
                                        opt_state_table, reference_table)
from repro_torch.models.sharding import is_dtensor


def _sharded(params) -> bool:
    return any(is_dtensor(t) for t in named_tensors(params).values())


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process with no group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host_tables(params, opt_state) -> dict[str, dict[str, np.ndarray]]:
    host = {"params": reference_table(params)}
    if opt_state is not None:
        host["opt"] = opt_state_table(opt_state)
    return host


def _fill(template, table: dict, prefix: str = ""):
    """The template's tensors read from ``table``: a module is filled in
    place and returned; a dict gives a new dict of the same layout."""
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for name, p in named_tensors(template).items():
                new = from_table(table, name, p, prefix)
                if is_dtensor(p):
                    p.to_local().copy_(new.to_local())
                else:
                    p.copy_(new)
        return template
    out = {}
    for key, value in template.items():
        if isinstance(value, dict):
            out[key] = _fill(value, table, f"{prefix}{key}/")
        else:
            out[key] = from_table(table, key, value, prefix)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, params, opt_state: dict | None = None,
             extra: dict | None = None) -> str:
        self.wait()  # one async write in flight at a time
        host = _host_tables(params, opt_state)
        path = os.path.join(self.dir, f"step_{step:08d}")
        if _writer():
            path = self._write(step, host, extra or {})
        if _sharded(params):
            _barrier()  # the files exist before any rank reads them
        return path

    def save_async(self, step: int, params, opt_state: dict | None = None,
                   extra: dict | None = None) -> None:
        self.wait()
        host = _host_tables(params, opt_state)  # the host copy, taken now
        self._sync = _sharded(params)
        if not _writer():
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if getattr(self, "_sync", False):
            self._sync = False
            _barrier()

    def _write(self, step: int, host: dict, extra: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, table in host.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **table)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._rotate()
        return final

    def _rotate(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_template, opt_template: dict | None = None,
                step: int | None = None):
        """Returns ``(params, opt_state, manifest)``.  The templates give
        the names, shapes, dtypes and devices: a ``Params`` module is
        filled in place, a dict of tensors gives a new dict; the opt
        template is ``init_opt_state``'s layout.  ``opt_state`` is None
        where there is no template or no ``opt.npz``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "params.npz")) as z:
            params = _fill(params_template, dict(z))
        opt_state = None
        if opt_template is not None and os.path.exists(
                os.path.join(d, "opt.npz")):
            with np.load(os.path.join(d, "opt.npz")) as z:
                opt_state = opt_state_from_table(dict(z), opt_template)
        return params, opt_state, manifest
