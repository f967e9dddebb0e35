"""bayesrrcpp_tpu -- a Bayesian whole-genome regression engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
medical-genomics-group/BayesRRcpp reference (an Rcpp/Eigen package; see
SURVEY.md for the structural analysis).  Samplers:

- :class:`SpikeSlabSampler` -- BayesR spike-and-slab mixture Gibbs samplers
  (ungrouped, grouped + fixed effects, warm restart).
- :class:`HorseshoeSampler` -- regularized-horseshoe Gibbs sampler.

plus a reference-compatible functional API in :mod:`bayesrrcpp_tpu.api`
(``BayesRSamplerV2``, ``BayesRSamplerV2Groups``, ``BRV2Grstart``,
``HorseshoeR``) that reproduces the reference's CSV output schemas.
"""
import os as _os

import jax as _jax

# On a GPU a default-precision f32 matmul may run in TF32 (~3 decimal
# digits).  For this engine that is not a benign speed/accuracy trade: the
# Gibbs residual algebra runs THROUGH matmuls -- the dense X passes, the
# Gram builds and the eps rank-B applies -- and the sigmaE/sigmaG feedback
# loop amplifies the rounding into chain divergence at biobank scale.  So
# the package asks for full f32 ('highest').  Opt out (e.g. for an
# unrelated workload sharing the process) with
# BAYESRRCPP_MATMUL_PRECISION=default|float32|highest.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("BAYESRRCPP_MATMUL_PRECISION", "highest"))

from .config import BayesRConfig, ChainConfig, GroupsConfig, HorseshoeConfig
from .models.bayesr import SpikeSlabSampler
from .models.horseshoe import HorseshoeSampler
from . import distributions, simulate

__version__ = "0.1.0"

__all__ = [
    "BayesRConfig", "ChainConfig", "GroupsConfig", "HorseshoeConfig",
    "SpikeSlabSampler", "HorseshoeSampler", "distributions", "simulate",
]
