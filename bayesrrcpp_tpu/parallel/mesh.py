"""Device-mesh helpers.

The engine scales on a 2-D ``jax.sharding.Mesh`` with named axes:

- ``"m"`` -- marker (model) parallelism: the genotype matrix is column-sharded
  in contiguous block groups; each m-slice sweeps its own Gram blocks.
- ``"n"`` -- individual (data) parallelism: rows of X and the residual vector
  are sharded; per-block correlations ``r = X_b' eps`` are psum-reduced
  across the devices.

The mesh follows the algorithm alone: the cards of one host are joined all
to all (NVLink), so no device order is better than another.

The reference has no distributed analog at all (SURVEY.md section 2.4: its
only concurrency is a 2-thread OpenMP producer/consumer split,
src/BayesRv2.cpp:102-108).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

AXIS_M = "m"
AXIS_N = "n"


def make_mesh(m: int = 1, n: int = 1, devices=None) -> Mesh:
    """Build an (m, n) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if m * n > len(devices):
        raise ValueError(f"mesh {m}x{n} needs {m*n} devices, have {len(devices)}")
    dev = np.asarray(devices[: m * n]).reshape(m, n)
    return Mesh(dev, (AXIS_M, AXIS_N))
