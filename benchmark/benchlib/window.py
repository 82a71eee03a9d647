"""What a generator (``generators/<name>.py``) builds its measured window
from: the answers it keeps, the window's record, a seed-drawn sample of the
answers, and a profiler capture started and stopped at call boundaries.

A generator is the loop of one shape of traffic: one caller in a closed
loop, its next call made when the previous one returns (a stencil code's own
loop; the program's runners return once the device has drained). A traffic
mix (``traffic/<name>.json``) names its generator and the parameters it
reads; the generator file defines ``warm(model, traffic)`` (one call of
every shape the mix uses), ``run(model, traffic, seconds, seed, profiler)``
(the window, a `Window`) and ``control_answer(model, reference, inputs,
consts, traffic, dtype)`` (the plain reference in the program's place, as
one `Answer` of the mix).
"""

from __future__ import annotations

import contextlib
import random
import time
from dataclasses import dataclass, field

from . import trace as tr


@dataclass
class Answer:
    steps: int           # steps from the seed-made state
    state: object        # what the program returned


@dataclass
class Window:
    seconds: float = 0.0
    calls: list = field(default_factory=list)      # [(seconds, steps)] a call
    steps: int = 0                                 # steps in the window
    answers: list = field(default_factory=list)    # the sample
    attempted: int = 0                             # answers the window produced
    trace: object = None                           # `trace.TraceData` or None


class Sample:
    """A uniform seed-drawn sample of ``k`` answers (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = int(k), random.Random(seed ^ 0x5A3D), 0, []

    def offer(self, answer):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(answer)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = answer


class Capture:
    """Starts and stops the profiler at call boundaries: from ``start_s``
    into the window, for about ``seconds`` (the mix's ``trace``)."""

    def __init__(self, params, profiler, t0):
        self.prof = profiler if params else None
        self.start_s = float(params["start_s"]) if params else 0.0
        self.len_s = float(params["seconds"]) if params else 0.0
        self.t0, self.on, self.done, self.steps, self.t_on = t0, False, False, 0, 0.0

    def before(self):
        now = time.perf_counter()
        if self.prof and not (self.on or self.done) and now - self.t0 >= self.start_s:
            self.prof.start()
            self.on, self.t_on = True, now

    def span(self):
        """The benchmark's span around one call, while a capture runs."""
        if self.on:
            import torch

            return torch.profiler.record_function(tr.CALL)
        return contextlib.nullcontext()

    def after(self, steps):
        if self.on:
            self.steps += steps
            if time.perf_counter() - self.t_on >= self.len_s:
                self.stop()

    def stop(self):
        if self.on:
            self.prof.stop()
            self.on, self.done = False, True

    def collect(self):
        self.stop()
        return tr.reduce(self.prof.collect(), self.steps) if self.done else None
