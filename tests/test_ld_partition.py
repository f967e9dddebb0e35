"""Fixed strided-partition semantics under LD.

tools/ld_validation.py compares the exact-sequential J=1 anchor against
the strided-rounds auto plan on AR(1)-correlated genotypes; this
slow-tier test runs a reduced shape with quantitative bounds.  A
full-scale run on the GPU is not recorded yet.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


@pytest.mark.slow
def test_strided_partition_under_ld():
    from ld_validation import run

    cmp = run(N=700, M=2048, rho=0.9, iters=500, seed=5, block=64)
    assert cmp["config"]["J_auto"] > 1          # the partition under test
    # both kernels recover the same posterior
    assert cmp["pair_posterior_corr"] > 0.95, cmp
    assert cmp["pve_rel_diff"] < 0.15, cmp
    # mixing is not degraded by the fixed partition
    assert cmp["ess_ratio_auto_vs_J1"] > 0.6, cmp
    assert cmp["ess_causal_ratio"] > 0.5, cmp
    assert cmp["rhat_q99_auto"] < 1.2, cmp
    assert cmp["rhat_q99_J1"] < 1.2, cmp
    # and both recover the truth comparably
    assert cmp["corr_true_auto"] > 0.8 * cmp["corr_true_J1"], cmp
