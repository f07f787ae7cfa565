"""Batched serving loop: continuous batching on top of prefill and
decode_step, the reference package's ``launch/serve.py`` on torch.

Requests arrive with prompts and are packed into a fixed number of slots.
Each prompt is prefilled into a one-slot cache that is scattered into the
batch cache (every leaf of its nested dicts: KV, MLA latents, recurrent
states); each engine step decodes one token, greedily, for every slot;
a finished slot is refilled from the queue.  As in the reference, a step
decodes every slot at one position, the largest of the slots' positions
(``ROADMAP.md`` queue 3, fault 5): a slot with a shorter prompt writes its
token at that position and attends over the gap before it.

The engine casts the float32 weights to the compute dtype once, when it is
built, and runs under ``torch.inference_mode()``.  Like the reference, it
passes no ``image_embeds``, so it cannot serve the ``vlm`` kind
(``ROADMAP.md`` queue 3, fault 6): ``Model.forward`` raises there.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch qwen3-1.7b --reduced --requests 8 --max-new 32

Without ``--device`` it runs on ``cuda:0`` and raises where there is no
card.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.model import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) or (S, nq)
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous batching engine."""

    @torch.inference_mode()
    def __init__(self, model: Model, params, batch_slots: int, max_len: int):
        self.model = model
        self.params = model.cast_params(params)
        self.slots = batch_slots
        self.max_len = max_len
        self.cache = model.init_cache(batch_slots, max_len)
        self.pos = np.zeros(batch_slots, np.int32)
        self.active: list[Request | None] = [None] * batch_slots
        cfg = model.cfg
        tok_shape = (batch_slots, 1, cfg.n_codebooks) if cfg.n_codebooks \
            else (batch_slots, 1)
        self.next_tok = np.zeros(tok_shape, np.int32)

    def _prefill_one(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Prefill one slot: runs the sequence through a one-slot cache and
        scatters the resulting KV into the batch cache at ``slot``.
        Returns the last position's logits."""
        small = self.model.init_cache(1, self.max_len)
        last, small = self.model.prefill(self.params, tokens, small)
        _scatter(self.cache, small, self.slots, slot)
        return last

    @torch.inference_mode()
    def submit(self, req: Request) -> bool:
        for i in range(self.slots):
            if self.active[i] is None:
                prompt = torch.from_numpy(np.asarray(req.prompt, np.int32))
                last = self._prefill_one(prompt[None].to(self.model.device),
                                         i)
                tok = last[0, -1].argmax(-1).cpu().numpy()
                self.next_tok[i, 0] = tok
                self.pos[i] = req.prompt.shape[0]
                self.active[i] = req
                req.out.append(tok)
                return True
        return False

    @torch.inference_mode()
    def step(self) -> int:
        """Decode one token for all active slots.  Returns #active."""
        if all(r is None for r in self.active):
            return 0
        pos = int(self.pos.max())  # uniform step position
        tokens = torch.from_numpy(self.next_tok).to(self.model.device)
        logits, self.cache = self.model.decode_step(self.params, tokens,
                                                    self.cache, pos)
        toks = logits[:, -1].argmax(-1).cpu().numpy()
        n_active = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = toks[i]
            req.out.append(tok)
            self.pos[i] += 1
            self.next_tok[i, 0] = tok
            if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
                req.done = True
                self.active[i] = None
            else:
                n_active += 1
        return n_active


def _scatter(cache: dict, small: dict, slots: int, slot: int) -> None:
    """Copy a one-slot cache into the batch cache at ``slot``, leaf by leaf
    of the nested dicts: each leaf's batch axis is the first whose size is
    ``slots`` in the batch cache and 1 in the one-slot cache."""
    for name, big in cache.items():
        one = small[name]
        if isinstance(big, dict):
            _scatter(big, one, slots, slot)
            continue
        ax = _batch_axis(big.shape, slots, one.shape)
        big.select(ax, slot).copy_(one.squeeze(ax))


def _batch_axis(big_shape, slots, one_shape) -> int:
    for ax, (b, o) in enumerate(zip(big_shape, one_shape)):
        if b == slots and o == 1:
            return ax
    raise ValueError(f"no batch axis: {big_shape} vs {one_shape}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the config for smoke runs "
                         "(--no-reduced for the full architecture)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{args.device}: no CUDA device (pass --device "
                           "cpu to serve on the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device)
    params = model.init_params(torch.Generator(device).manual_seed(0))
    engine = ServeEngine(model, params, args.slots, args.max_len)

    rng = np.random.default_rng(0)
    shape = (args.prompt_len, cfg.n_codebooks) if cfg.n_codebooks \
        else (args.prompt_len,)
    queue = [Request(i, rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
                     args.max_new) for i in range(args.requests)]
    done: list[Request] = []
    t0 = time.perf_counter()
    steps = 0
    pending = list(queue)
    while pending or any(r is not None for r in engine.active):
        while pending and engine.submit(pending[0]):
            pending.pop(0)
        engine.step()
        steps += 1
        done = [r for r in queue if r.done]
        if steps > 10_000:
            break
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in queue)
    print(f"[serve] {len(done)}/{len(queue)} requests, {n_tok} tokens "
          f"in {dt:.1f}s ({n_tok/dt:.1f} tok/s, {steps} engine steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
