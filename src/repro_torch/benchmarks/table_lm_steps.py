"""The framework integration table: LM train and decode steps measured
through the SAME Runner and OpSchedule that drive the FFT clients, on the
port (reduced configs).

Each (arch, mode) pair is a registered client whose Table-1 ops map onto
the LM workload: allocate = parameters and optimizer state (or the cache),
upload = the host batch to the device, init_forward = build the step (for
decode, prefill the cache first), execute_forward = one train or decode
step, download = the loss or the logits to the host.  The plan cache
memoizes the built step under the reference's key, so warm repetitions
measure the step alone, as warm FFT repetitions do.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..configs.base import get_config
from ..core.client import Problem, TorchContext
from ..core.plan import PlanCache, cached_build, executable_bytes
from ..core.registry import register_client
from ..core.schedule import OpSchedule, OpStep
from ..core.suite import Session, SuiteSpec
from ..core.wisdom import Wisdom
from ..data.pipeline import DataConfig, SyntheticTokens
from ..models.model import Model
from ..train.optimizer import OptConfig, init_opt_state
from ..train.trainer import build_train_step, upload
from .common import emit, run_suite

ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "xlstm-350m", "hymba-1.5b"]
SEQ_LEN = 64
BATCH = 4

#: LM steps have no inverse transform: their schedule says so, and the
#: shared Runner drives it with the same per-op timers.
LM_SCHEDULE = OpSchedule("lm_step", (
    OpStep("allocate", "allocate", bytes_method="get_alloc_size"),
    OpStep("upload", "upload", needs_input=True,
           bytes_method="get_transfer_size"),
    OpStep("init_forward", "init_forward", bytes_method="get_plan_size"),
    OpStep("execute_forward", "execute_forward"),
    OpStep("download", "download", captures_output=True),
    OpStep("destroy", "destroy"),
))


class LMStepClient:
    """Generic (non-FFT) client: one LM step behind the Table-1 protocol,
    on the context's device."""

    title = "LMStep"
    arch = "qwen3-1.7b"
    mode = "train"          # 'train' | 'decode'
    schedule = LM_SCHEDULE

    def __init__(self, problem: Problem, context: TorchContext, rigor=None,
                 wisdom: Wisdom | None = None,
                 plan_cache: PlanCache | None = None):
        self.problem = problem
        self.context = context
        self.plan_cache = plan_cache
        self.cache_events: dict[str, str] = {}
        self.cfg = get_config(self.arch).reduced()
        self.model = Model(self.cfg, device=context.device, remat=False)
        self.params = None
        self.opt = None
        self.cache = None
        self.batch = None
        self._step = None
        self._out = None
        self._plan_bytes = 0
        # sizes are snapshotted while the state exists: the Runner queries
        # the byte accessors after destroy() has dropped it
        self._alloc_bytes = 0
        self._transfer_bytes = 0

    # --- host input / validation hooks ------------------------------------
    @classmethod
    def make_host_input(cls, problem: Problem, seed: int) -> dict:
        cfg = get_config(cls.arch).reduced()
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=problem.extents[0],
                                          global_batch=problem.batch,
                                          n_codebooks=cfg.n_codebooks))
        return data.batch(seed % 1000)

    @classmethod
    def check(cls, problem, host_in, out, error_bound):
        ok = bool(np.all(np.isfinite(np.asarray(out))))
        return ok, "" if ok else "non-finite step output"

    def _sync(self) -> None:
        if self.context.device.type == "cuda":
            torch.cuda.synchronize(self.context.device)

    # --- memory -----------------------------------------------------------
    def allocate(self) -> None:
        gen = torch.Generator(self.context.device).manual_seed(0)
        self.params = self.model.init_params(gen)
        if self.mode == "train":
            self.opt = init_opt_state(self.params)
        else:
            self.cache = self.model.init_cache(self.problem.batch,
                                               self.problem.extents[0] + 32)
        self._sync()
        self._alloc_bytes = int(sum(p.numel() * p.element_size()
                                    for p in self.params.parameters()))

    def destroy(self) -> None:
        self.params = self.opt = self.cache = self.batch = None
        self._step = self._out = None

    def get_alloc_size(self) -> int:
        return self._alloc_bytes

    def get_transfer_size(self) -> int:
        return self._transfer_bytes

    def get_plan_size(self) -> int:
        return self._plan_bytes

    # --- transfer ---------------------------------------------------------
    def upload(self, host_batch: dict) -> None:
        self._transfer_bytes = int(sum(v.numel() * v.element_size()
                                       for v in host_batch.values()))
        self.batch = upload(host_batch, self.context.device)
        self._sync()

    def download(self) -> np.ndarray:
        return self._out.float().cpu().numpy()

    # --- planning ---------------------------------------------------------
    def _built(self, tag: str, build):
        """The built step, memoized per (device, problem, arch, mode) when
        a plan cache is attached: warm repetitions skip the build."""
        key = PlanCache.executable_key(
            getattr(self.context, "device_kind", "?"), self.problem,
            f"lm_{self.mode}[{self.arch}]", tag)
        return cached_build(self.plan_cache, self.cache_events,
                            "init_forward", key, build)

    def init_forward(self) -> None:
        if self.mode == "train":
            self._step = self._built("forward", lambda: build_train_step(
                self.model, OptConfig()))
        else:
            # the serving path's setup: prefill the cache, then the step
            with torch.inference_mode():
                self.model.prefill(self.params, self.batch["tokens"],
                                   self.cache)
            model = self.model
            self._step = self._built(
                "forward", lambda: torch.inference_mode()(
                    lambda p, t, c, q: model.decode_step(p, t, c, q)[0]))
        self._plan_bytes = executable_bytes(self._step)
        self._sync()

    # --- execution --------------------------------------------------------
    def execute_forward(self) -> None:
        if self.mode == "train":
            _, _, metrics = self._step(self.params, self.opt, self.batch)
            self._out = metrics["loss"]
        else:
            tok = self.batch["tokens"][:, :1]
            self._out = self._step(self.params, tok, self.cache,
                                   self.problem.extents[0])
        self._sync()


def _registered(arch: str, mode: str) -> type:
    name = f"LM{'Train' if mode == 'train' else 'Decode'}-{arch}"
    cls = type(name.replace("-", "_").replace(".", "_"), (LMStepClient,),
               {"title": name, "arch": arch, "mode": mode})
    return register_client()(cls)


CLIENTS = {(a, m): _registered(a, m) for a in ARCHS
           for m in ("train", "decode")}

#: Declarative spec: clients by registered name, extents = the sequence
#: length, batch = the LM batch.  plan_cache=True memoizes the built step
#: so warm repetitions measure the step alone.
SPEC = SuiteSpec(clients=tuple(CLIENTS[(a, m)].title
                               for a in ARCHS for m in ("train", "decode")),
                 extents=(str(SEQ_LEN),), kinds=("Outplace_Real",),
                 precisions=("float",), batch=BATCH,
                 warmups=1, plan_cache=True, output=None)


def run(reps: int = 3, session: Session | None = None) -> None:
    """The spec through ``Session.run`` (a fresh Session on ``cuda:0``
    unless one is given); one CSV row of mean ``execute_forward`` us per
    client."""
    results = run_suite(replace(SPEC, repetitions=reps), session)
    for a in results.aggregate_named(op="execute_forward"):
        lib = a.library
        mode, arch = ("train", lib[len("LMTrain-"):]) \
            if lib.startswith("LMTrain-") \
            else ("decode", lib[len("LMDecode-"):])
        emit(f"lm/{mode}_step/{arch}", a.mean * 1e3,
             f"reduced b{BATCH}s{SEQ_LEN}")
