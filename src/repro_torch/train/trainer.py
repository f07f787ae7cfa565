"""Trainer: the train loop with checkpoint/restart, preemption handling, a
straggler watchdog, microbatch gradient accumulation and optional int8
gradient compression.  The reference package's ``train/trainer.py`` on one
device.

Fault-tolerance model:
- SIGTERM/SIGINT set a flag: the loop finishes the step in flight,
  checkpoints and stops, so a preempted worker restarts from step N + 1.
- Checkpoints are in the reference's logical layout
  (``train/checkpoint.py``), so either package resumes the other's.
- The data pipeline (``data/pipeline.py``) is indexed by step, so a
  restart never replays or skips a batch.
- Straggler watchdog: a step slower than ``straggler_factor`` x the
  median of the last 50 is recorded by index.

A step is eager: autograd's backward through the model, then AdamW's
``_foreach`` update in place.  Its time is the host clock around the step
after a synchronize, so it spans the device work.

Sharded training (``Trainer(model, data, cfg, mesh=...)``, the model
built on the same mesh): parameters, ``m`` and ``v`` are DTensors laid
out by ``param_specs`` and ``step`` is a host scalar every rank holds.
Every rank draws the same global batch (the pipeline's seed does not
depend on the rank) and the model takes its dp rows, as the reference's
``in_shardings`` do; each microbatch still shards over dp, so there are
at most ``global_batch // dp`` of them.
"""

from __future__ import annotations

import signal
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.models.convert import named_tensors
from repro_torch.models.model import Model
from repro_torch.models.sharding import is_dtensor, local
from . import compression
from .checkpoint import CheckpointManager
from .optimizer import OptConfig, adamw_update, init_opt_state


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # gradient accumulation
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    grad_compression: bool = False
    straggler_factor: float = 2.0
    log_every: int = 10
    opt: OptConfig = field(default_factory=OptConfig)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(batch: dict, device: torch.device) -> dict:
    """The batch's tensors on ``device``."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def value_and_grad(model: Model, params, batch: dict):
    """``((total, metrics), grads)`` of ``model.loss_fn``: grads by
    state-dict name, one for every parameter (each is made to require
    grad), metrics detached."""
    named = named_tensors(params)
    for p in named.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        total, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(total, list(named.values()))
    # a sharded gradient in its parameter's layout; values whole
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(g) and g.placements != p.placements else g
             for g, p in zip(grads, named.values())]
    metrics = {k: _whole(v) for k, v in metrics.items()}
    return (_whole(total), metrics), dict(zip(named, grads))


def _whole(v):
    """A metric detached, a DTensor gathered whole."""
    if not isinstance(v, torch.Tensor):
        return v
    v = v.detach()
    return v.full_tensor() if is_dtensor(v) else v


def build_train_step(model: Model, opt_cfg: OptConfig, microbatches: int = 1,
                     grad_compression: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch[, residual]) ->
    (params, opt_state, metrics[, residual])``; the parameters and the
    moments are updated in place."""

    def grads_of(params, batch):
        if microbatches == 1:
            (_, metrics), grads = value_and_grad(model, params, batch)
            return grads, metrics
        # accumulate over microbatches in float32, then average
        b = next(iter(batch.values())).shape[0]
        acc = None
        for i in range(microbatches):
            mb = {k: v.reshape(microbatches, b // microbatches,
                               *v.shape[1:])[i] for k, v in batch.items()}
            (_, metrics), grads = value_and_grad(model, params, mb)
            if acc is None:
                acc = {k: g.float() for k, g in grads.items()}
            else:
                torch._foreach_add_([local(a) for a in acc.values()],
                                    [local(grads[k]) for k in acc])
            del grads
        torch._foreach_div_([local(a) for a in acc.values()], microbatches)
        return acc, metrics  # the last microbatch's metrics

    if not grad_compression:
        def train_step(params, opt_state, batch):
            grads, metrics = grads_of(params, batch)
            params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                 opt_state)
            return params, opt_state, {**metrics, **om}
        return train_step

    def train_step_ef(params, opt_state, batch, residual):
        grads, metrics = grads_of(params, batch)
        (q, s), residual = compression.compress_tree(grads, residual)
        grads = compression.decompress_tree(q, s)  # int8 over the DP reduce
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {**metrics, **om}, residual
    return train_step_ef


class Trainer:
    def __init__(self, model: Model, data, cfg: TrainConfig, mesh=None):
        if mesh is not None and model.mesh is not mesh:
            raise ValueError(f"the model is not built on the trainer's "
                             f"mesh {mesh}: build Model(cfg, mesh=mesh)")
        self.model = model
        self.data = data
        self.cfg = cfg
        self.mesh = model.mesh
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints)
        self._stop = False
        self._step_times: list[float] = []
        self.stragglers: list[int] = []

    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True  # finish the current step, checkpoint, stop
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (tests)

    # ------------------------------------------------------------------
    def run(self, gen: torch.Generator | None = None, resume: bool = True,
            verbose: bool = True) -> dict:
        """Train to ``cfg.steps`` from fresh parameters drawn from ``gen``
        (by default a generator on the model's device seeded 0), or from
        the latest checkpoint.  Returns the final step, loss, parameters,
        whether it was preempted and the stragglers' steps."""
        cfg = self.cfg
        model = self.model
        self._install_signals()

        if gen is None:
            gen = torch.Generator(model.device).manual_seed(0)
        params = model.init_params(gen)
        opt_state = init_opt_state(params)
        start_step = 0
        if resume and self.ckpt.latest_step() is not None:
            params, opt_state, manifest = self.ckpt.restore(params, opt_state)
            start_step = manifest["step"]
            if verbose:
                print(f"[trainer] resumed from step {start_step}")

        micro = cfg.microbatches
        if self.mesh is not None:
            # each microbatch must still shard over dp
            batch = getattr(getattr(self.data, "cfg", None),
                            "global_batch", None)
            if batch is not None:
                micro = min(micro, max(1, batch // model.sh.dp_size))
        step_fn = build_train_step(model, cfg.opt, micro,
                                   cfg.grad_compression)
        residual = compression.init_residual(params) \
            if cfg.grad_compression else None

        metrics: dict = {}
        step = start_step
        while step < cfg.steps and not self._stop:
            batch = upload(self.data.batch(step), model.device)
            _sync(model.device)
            t0 = time.perf_counter()
            if cfg.grad_compression:
                params, opt_state, metrics, residual = step_fn(
                    params, opt_state, batch, residual)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(model.device)
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            step += 1
            if verbose and step % cfg.log_every == 0:
                print(f"[trainer] step {step} loss "
                      f"{float(metrics['loss']):.4f} gnorm "
                      f"{float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if step % cfg.checkpoint_every == 0 or self._stop \
                    or step == cfg.steps:
                self.ckpt.save(step, params, opt_state,
                               extra={"preempted": self._stop})
        self.ckpt.wait()
        return {"step": step, "loss": float(metrics.get("loss", float("nan"))),
                "params": params, "preempted": self._stop,
                "stragglers": list(self.stragglers)}

    def _watchdog(self, step: int, dt: float) -> None:
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.cfg.straggler_factor * med:
                self.stragglers.append(step)
