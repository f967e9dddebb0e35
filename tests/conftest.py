"""Test configuration: CPU backend with a virtual 8-device mesh and x64.

Tests run on the local CPU even where a GPU is present: the platform is
forced before any backend is initialised.  Multi-device sharding is
validated on a virtual 8-device CPU mesh, and float64 lets
reference-parity tests run at the Rcpp reference's precision (all-f64
Eigen).

``chip_smoke.py`` runs the ``gpu``-marked tests inside its own process on
the card; it sets BAYESRRCPP_TEST_ON_DEVICE=1, which leaves JAX's device
and dtype configuration alone.
"""
import os


ON_DEVICE = os.environ.get("BAYESRRCPP_TEST_ON_DEVICE") == "1"

_flags = os.environ.get("XLA_FLAGS", "")
if not ON_DEVICE:
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    # Persistent compile cache: the tier is compile-bound and the cache
    # keys on HLO, so identical sampler compiles de-dup across tests,
    # xdist workers and runs.  JAX_COMPILATION_CACHE_DIR, where set, wins.
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(os.path.dirname(__file__), "..",
                                       ".jax_cache_tests"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8, "virtual 8-device CPU mesh not active"
