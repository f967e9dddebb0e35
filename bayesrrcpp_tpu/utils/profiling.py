"""Profiling / throughput instrumentation.

The reference's only instrumentation is a whole-chain wall-clock print
(reference: src/BayesRv2.cpp:167, 276-278).  This module provides the
north-star counter (SNP-updates/s, BASELINE.json) and an optional
``jax.profiler`` trace context for per-op device timelines.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import jax


@dataclass
class ChainStats:
    """Throughput accounting for a sampler run."""

    markers: int
    iterations: int = 0
    elapsed_s: float = 0.0
    compile_s: float = 0.0

    @property
    def snp_updates_per_sec(self) -> float:
        return (self.markers * self.iterations / self.elapsed_s
                if self.elapsed_s else 0.0)

    @property
    def gibbs_iters_per_min(self) -> float:
        return 60.0 * self.iterations / self.elapsed_s if self.elapsed_s else 0.0

    def as_dict(self):
        return {
            "markers": self.markers,
            "iterations": self.iterations,
            "elapsed_s": round(self.elapsed_s, 3),
            "compile_s": round(self.compile_s, 3),
            "snp_updates_per_sec": round(self.snp_updates_per_sec, 1),
            "gibbs_iters_per_min": round(self.gibbs_iters_per_min, 2),
        }


class ChainTimer:
    """Measure sampler throughput with warmup-aware timing.

    Usage:
        timer = ChainTimer(markers=sampler.M)
        with timer.compile():            # first call (jit compile + run)
            state = sampler._run_steps(state, sampler.data, n)
            jax.block_until_ready(state.eps)
        with timer.measure(n):
            state = sampler._run_steps(state, sampler.data, n)
            jax.block_until_ready(state.eps)
        print(timer.stats.as_dict())
    """

    def __init__(self, markers: int):
        self.stats = ChainStats(markers=markers)

    @contextlib.contextmanager
    def compile(self):
        t0 = time.perf_counter()
        yield
        self.stats.compile_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def measure(self, iterations: int):
        t0 = time.perf_counter()
        yield
        self.stats.elapsed_s += time.perf_counter() - t0
        self.stats.iterations += iterations


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """jax.profiler trace context (view with TensorBoard / xprof).

    No-op when ``log_dir`` is None so call sites can keep the context
    unconditionally.
    """
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
