"""Chain parallelism over devices: fused multi-chain sweeps on every card.

Composes the two chain-scaling mechanisms:

- within a device, one strided sweep serves C_local chains, reading X once
  per round for all of them (ops/strided.py);
- across devices, a 1-D ``("c",)`` mesh shards the chain axis of the
  batched state pytree with the dataset replicated -- chains never
  interact, so the step needs NO collectives at all (shard_map with empty
  specs for data).

The reference runs one chain per R process (src/BayesRv2.cpp:171).

Determinism: chain keys are split once from the root key and sharded, so
shard g's results are identical to an unsharded fused run over that key
slice (the marker visit order comes from each shard's first local chain) --
tests/test_chain_parallel.py pins this.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_C = "c"


def chain_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the chain axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS_C,))


class ChainParallelRunner:
    """Run a sampler's fused multi-chain step sharded over a chain mesh.

    ``sampler`` is a SpikeSlabSampler or HorseshoeSampler whose
    ``supports_fused_chains`` is True; ``n_chains`` must be a multiple of
    the mesh size.
    """

    def __init__(self, sampler, mesh: Mesh):
        if not sampler.supports_fused_chains:
            raise ValueError("sampler does not support fused "
                             "multi-chain steps")
        if tuple(mesh.axis_names) != (AXIS_C,):
            raise ValueError("mesh must have the single axis ('c',)")
        self.sampler = sampler
        self.mesh = mesh
        self.n_devices = mesh.devices.size

        samp = sampler

        @functools.partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
        def _steps(state, data, n):
            f = jax.shard_map(
                lambda st, d: jax.lax.fori_loop(
                    0, n, lambda i, x: samp._mc_step_impl(x, d), st),
                mesh=mesh, in_specs=(P(AXIS_C), P()), out_specs=P(AXIS_C),
                check_vma=False)
            return f(state, data)

        @functools.partial(jax.jit, static_argnums=(2, 3),
                           donate_argnums=(0,))
        def _emit(state, data, n_emits, thinning):
            f = jax.shard_map(
                lambda st, d: samp._mc_emit_chunk_impl(st, d, n_emits,
                                                       thinning),
                mesh=mesh, in_specs=(P(AXIS_C), P()),
                out_specs=(P(AXIS_C), P(None, AXIS_C)), check_vma=False)
            return f(state, data)

        self._steps = _steps
        self._emit = _emit

    def init(self, key, n_chains: int):
        if n_chains % self.n_devices:
            raise ValueError(f"n_chains={n_chains} must be a multiple of "
                             f"the {self.n_devices}-device chain mesh")
        keys = jax.random.split(key, n_chains)
        state = jax.vmap(self.sampler.init)(keys)
        sh = NamedSharding(self.mesh, P(AXIS_C))
        return jax.tree.map(lambda x: jax.device_put(x, sh), state)

    def run(self, key, n_chains: int, chain, *, collect: bool = True,
            emit_chunk: int = 32, sink=None):
        """Full sharded multi-chain run; collected arrays are
        (emits, n_chains, ...) like run_chains."""
        from ..models.driver import run_chain

        state = self.init(key, n_chains)
        data = self.sampler.data
        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._steps(st, data, n),
            emit_fn=lambda st, n, t: self._emit(st, data, n, t),
            sink=sink, collect=collect, emit_chunk=emit_chunk)
