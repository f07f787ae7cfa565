"""Declarative op schedules + the generic Runner.

gearshifft's measurement loop (paper §2.2, Fig. 1) is a fixed sequence of
individually timed client operations.  An :class:`OpSchedule` declares it
as data: a tuple of :class:`OpStep` rows naming the client method, what the
step consumes (``needs_input``) and produces (``captures_output``), and
which client accessor attributes bytes to the step's result row.

The :class:`Runner` drives any client through its schedule with the paper's
timing semantics:

* every step is wrapped in its own :class:`~repro_torch.core.timer.Timer`;
* ``total`` spans the first step through the last;
* warmup runs execute fully but are never recorded (except the ops that
  paid a cold plan-cache build);
* byte attributions are queried once per counted run, after the last step;
* per-op plan-cache events (``hit``/``miss``) are collected from the
  client's ``cache_events`` dict when present.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .timer import Timer


@dataclass(frozen=True)
class OpStep:
    """One timed operation of a schedule.

    ``method`` names the client attribute to call; ``bytes_method`` names the
    client accessor whose return value is recorded as the step's byte count.
    """

    name: str
    method: str
    needs_input: bool = False       # call with the run's host input
    captures_output: bool = False   # return value becomes the run output
    bytes_method: str | None = None


@dataclass(frozen=True)
class OpSchedule:
    """An ordered, named sequence of timed steps."""

    name: str
    steps: tuple[OpStep, ...]

    @property
    def op_names(self) -> tuple[str, ...]:
        """Row op values emitted per run — every step plus ``total``."""
        return tuple(s.name for s in self.steps) + ("total",)


#: The paper's Table-1 sequence, verbatim (allocate .. destroy).
FFT_SCHEDULE = OpSchedule("fft", (
    OpStep("allocate", "allocate", bytes_method="get_alloc_size"),
    OpStep("init_forward", "init_forward", bytes_method="get_plan_size"),
    OpStep("upload", "upload", needs_input=True,
           bytes_method="get_transfer_size"),
    OpStep("execute_forward", "execute_forward"),
    OpStep("init_inverse", "init_inverse", bytes_method="get_plan_size"),
    OpStep("execute_inverse", "execute_inverse"),
    OpStep("download", "download", captures_output=True,
           bytes_method="get_transfer_size"),
    OpStep("destroy", "destroy"),
))


@dataclass
class RunRecord:
    """Measurements of one run.  ``warmup`` records (negative run index) are
    produced only when a warmup run performed a cold plan-cache build, so
    planning cost stays measured even when the cache fills before run 0."""

    run: int
    times: dict[str, float]            # op name (incl. 'total') -> ms
    nbytes: dict[str, int] = field(default_factory=dict)
    cache: dict[str, str] = field(default_factory=dict)  # op -> 'hit'|'miss'
    warmup: bool = False


@dataclass
class Runner:
    """Drives a fresh client through ``schedule`` for warmups + repetitions.

    ``make_client`` is called once per run (the paper constructs/destroys the
    client every run so allocation and planning stay measured quantities).
    Exceptions propagate to the caller; rows already handed to ``on_record``
    are kept.
    """

    schedule: OpSchedule
    warmups: int
    repetitions: int

    def run(self, make_client: Callable[[], Any], host_input: Any = None,
            on_record: Optional[Callable[[RunRecord], None]] = None,
            ) -> tuple[list[RunRecord], Any]:
        records: list[RunRecord] = []
        output: Any = None
        for run in range(-self.warmups, self.repetitions):
            client = make_client()
            times: dict[str, float] = {}
            t_total = Timer().start()
            for step in self.schedule.steps:
                fn = getattr(client, step.method)
                with Timer() as t:
                    ret = fn(host_input) if step.needs_input else fn()
                times[step.name] = t.time_ms
                if step.captures_output:
                    output = ret
            times["total"] = t_total.stop()
            nbytes = {s.name: getattr(client, s.bytes_method)()
                      for s in self.schedule.steps if s.bytes_method}
            cache = dict(getattr(client, "cache_events", ()) or {})
            if run >= 0:
                rec = RunRecord(run, times, nbytes, cache)
                records.append(rec)
                if on_record is not None:
                    on_record(rec)
            elif on_record is not None and "miss" in cache.values():
                on_record(RunRecord(run, times, nbytes, cache, warmup=True))
        return records, output
