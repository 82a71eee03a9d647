"""The performance oracle's live half: `robust_z` and `PerfWatch`.

Counterpart of the last part of `implicitglobalgrid_tpu/telemetry/perfmodel.py`
(`robust_z` :706, `PerfWatch` :728): the drift detector the resilient driver
feeds one observation per chunk boundary, pure host arithmetic. The model
half (`MachineProfile`, `predict_step`, `calibrate_machine`) is not ported:
its coefficients must be measured on the card, not carried over from the
TPU. `run_resilient(perf_model=)` takes a `predict_step`-shaped dict (its
``step_s``) or plain modeled seconds a step meanwhile.
"""

from __future__ import annotations

from collections import deque

from ..utils.exceptions import InvalidArgumentError

__all__ = ["robust_z", "PerfWatch"]


def robust_z(value: float, history, *, rel_floor: float = 0.02,
             min_samples: int = 2) -> tuple:
    """The house robust z-score: ``(z, median, mad)`` of ``value``
    against ``history`` (an iterable of floats), with

        z = (value - median) / max(1.4826 * MAD, rel_floor * median, 1e-12)

    — the one estimator shared by `PerfWatch` (in-driver drift detection)
    and the JAX package's observer-side `telemetry.live.LiveAggregate`, so
    the two can never disagree on what counts as a regression. Returns
    ``(None, None, None)`` before ``min_samples`` history entries."""
    from statistics import median

    hist = list(history)
    if len(hist) < max(2, int(min_samples)):
        return None, None, None
    med = median(hist)
    mad = median([abs(x - med) for x in hist])
    sigma = max(1.4826 * mad, rel_floor * med, 1e-12)
    return (float(value) - med) / sigma, med, mad


class PerfWatch:
    """Live drift detector over per-chunk step times (host-side only).

    The driver feeds it one observation per chunk boundary
    (``observe(...)``); it maintains a rolling baseline of per-STEP
    execution time (median + MAD over ``window`` chunks — robust to the
    occasional slow fetch) and a modeled ratio when a prediction is
    given. An observation whose robust z-score

        z = (per_step - median) / max(1.4826 * MAD, rel_floor * median)

    exceeds ``zmax`` (after ``min_samples`` warm-up chunks) returns a
    regression record the driver emits as a ``perf_regression`` flight
    event. Chunks marked ``cold`` (the dispatch paid a compile after a
    runner-cache miss; the port caches no runner, so its driver marks
    none) update the gauges but neither test nor pollute the baseline. Every observation lands in the ``igg_perf_*`` gauges
    (`telemetry.hooks.observe_perf`), so the live ``/metrics`` endpoint
    always shows the current per-step time, model ratio, and z-score."""

    def __init__(self, *, window: int = 16, zmax: float = 4.0,
                 model_step_s: float | None = None, min_samples: int = 5,
                 rel_floor: float = 0.02):
        if window < 2:
            raise InvalidArgumentError(
                f"PerfWatch needs window >= 2 (got {window}).")
        self.window = int(window)
        self.zmax = float(zmax)
        # clamped to the window: a deque of maxlen=window can never hold
        # min_samples > window entries, which would silently disable the
        # z-test for small perf_window values
        self.min_samples = max(2, min(int(min_samples), self.window))
        self.rel_floor = float(rel_floor)
        self.model_step_s = (None if model_step_s is None
                             else float(model_step_s))
        self._hist: deque = deque(maxlen=self.window)
        self.regressions = 0

    def baseline_s(self) -> float | None:
        """The current warm per-step baseline (median of the rolling
        window), or None before ``min_samples`` warm chunks — the
        measured-price fallback the driver's deadline-slack computation
        uses when no perf model was attached."""
        from statistics import median

        if len(self._hist) < self.min_samples:
            return None
        return float(median(self._hist))

    def observe(self, *, chunk, step_begin, step_end, n, exec_s,
                cold: bool = False) -> dict | None:
        """One chunk boundary. Returns the regression record (or None)."""
        from .hooks import observe_perf

        per_step = float(exec_s) / max(1, int(n))
        ratio = (per_step / self.model_step_s
                 if self.model_step_s else None)
        z, med, mad = robust_z(per_step, self._hist,
                               rel_floor=self.rel_floor,
                               min_samples=self.min_samples)
        verdict = None
        if z is not None:
            if not cold and z > self.zmax:
                self.regressions += 1
                verdict = {"chunk": chunk, "step_begin": step_begin,
                           "step_end": step_end, "per_step_s": per_step,
                           "baseline_s": med, "mad_s": mad, "z": z,
                           "ratio": ratio}
        if not cold:
            self._hist.append(per_step)
        observe_perf(per_step, ratio=ratio, z=z,
                     regression=verdict is not None)
        return verdict
