"""Chunk mixes: calls of ``steps_per_call`` steps back to back, each from
the seed-made state (``members``: an ensemble of that many, made by the
configuration's reference), until ``--seconds`` have passed; the window
ends at the return of the call that crosses it. Keeps a seed-drawn sample
of ``sample`` answers; with a profiler, captures the mix's ``trace``
stretch of calls."""

from __future__ import annotations

import time

from benchlib.window import Answer, Capture, Sample, Window


def warm(model, traffic):
    model.advance(model.state, int(traffic["steps_per_call"]))


def run(model, traffic, seconds, seed, profiler=None) -> Window:
    steps = int(traffic["steps_per_call"])
    sample = Sample(traffic.get("sample", 1), seed)
    w = Window()
    t0 = time.perf_counter()
    cap = Capture(traffic.get("trace"), profiler, t0)
    while True:
        cap.before()
        ts = time.perf_counter()
        with cap.span():
            out = model.advance(model.state, steps)
        te = time.perf_counter()
        w.calls.append((te - ts, steps))
        w.steps += steps
        cap.after(steps)
        sample.offer(Answer(steps, out))
        del out
        if te - t0 >= seconds:
            break
    w.seconds = te - t0
    w.attempted = len(w.calls)
    w.answers = sample.items
    w.trace = cap.collect() if profiler else None
    return w


def control_answer(model, reference, inputs, consts, traffic, dtype) -> Answer:
    """One call's worth of steps of the plain reference in ``dtype``, in the
    program's layout."""
    steps = int(traffic["steps_per_call"])
    low = reference.run(inputs, consts, {"steps": [steps]}, dtype)
    return Answer(steps, model.answer_state(low["at"][steps]))
