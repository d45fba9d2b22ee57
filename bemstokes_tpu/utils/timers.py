"""Named wall-clock timers — the analog of the reference's five
Teuchos::TimeMonitor timers (Run, Assemble, LAC Solve, BEM Reinitialisation,
DirectPreconditioner Refactorisation; `source/bem_stokes.cc:19-23`, RAII
scopes at `:2844, 4161, 5639, 5770`, summarized at `:5882`), extended with
optional jax.profiler traces for per-kernel device timelines.

Timing JAX correctly requires a device sync at scope exit, otherwise the
timer only sees dispatch; scopes take `sync=` pytrees to block on.
"""

from __future__ import annotations

import contextlib
import time


class _Timer:
    __slots__ = ("total", "calls")

    def __init__(self):
        self.total = 0.0
        self.calls = 0


class TimerRegistry:
    def __init__(self):
        self._timers: dict[str, _Timer] = {}

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        """RAII timing scope.  `sync`: optional array pytree to
        block_until_ready on before stopping the clock."""
        t = self._timers.setdefault(name, _Timer())
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import jax

                jax.block_until_ready(sync)
            t.total += time.perf_counter() - t0
            t.calls += 1

    def add(self, name: str, seconds: float):
        t = self._timers.setdefault(name, _Timer())
        t.total += seconds
        t.calls += 1

    def reset(self):
        self._timers.clear()

    def summary(self) -> str:
        """Teuchos-style summary table."""
        if not self._timers:
            return "(no timers recorded)"
        w = max(len(n) for n in self._timers) + 2
        lines = [
            f"{'Timer':<{w}}{'Calls':>8}{'Total (s)':>12}{'Mean (ms)':>12}",
            "-" * (w + 32),
        ]
        for name, t in sorted(self._timers.items()):
            mean_ms = (t.total / t.calls * 1e3) if t.calls else 0.0
            lines.append(f"{name:<{w}}{t.calls:>8}{t.total:>12.3f}{mean_ms:>12.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            name: {"calls": t.calls, "total_s": t.total}
            for name, t in self._timers.items()
        }

    @contextlib.contextmanager
    def profile(self, logdir: str):
        """jax.profiler trace around a region (view with TensorBoard /
        xprof); the per-kernel device timeline the reference never had."""
        import jax

        jax.profiler.start_trace(logdir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()


#: process-global registry (the reference's static Teuchos timers)
timers = TimerRegistry()
