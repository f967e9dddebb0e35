"""Multi-host (fake-pod) validation: jax.distributed over CPU processes.

SURVEY.md section 4(d): a 2-process CPU cluster (2 virtual devices each)
must reproduce the single-process chain on the same (2, 2) mesh shape --
the sampler's math depends only on the MESH SHAPE (per-slice RNG folds the
m-coordinate), never on how devices map to processes.  Also covers per-host
marker-slab placement (x_process_shard) and the marker-slice .bed reads
that feed it (reference gap: the reference is single-process only,
src/BayesRv2.cpp:102-108).
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import GroupsConfig
from bayesrrcpp_tpu.parallel.mesh import make_mesh
from bayesrrcpp_tpu.parallel.sharded import ShardedSpikeSlabSampler

CVA = np.array([[0.001, 0.01, 0.1], [0.002, 0.02, 0.2]])


def make_problem():
    """Deterministic small problem shared by the parent and the fake-pod
    children (both build it independently from the same seed)."""
    rng = np.random.default_rng(1234)
    N, M = 96, 64
    X = rng.standard_normal((N, M)).astype(np.float32)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.4, 8)
    Y = (X @ beta_t + rng.normal(0, 0.8, N)).astype(np.float32)
    g_assign = (np.arange(M) % 2).astype(np.int32)
    return X, Y, CVA, g_assign


def _single_process_reference():
    X, Y, cva, g_assign = make_problem()
    mesh = make_mesh(2, 2)
    s = ShardedSpikeSlabSampler(X, Y, cva, GroupsConfig(block_size=16), mesh,
                                g_assign=g_assign,
                                dtype=jnp.float32)
    state = s.init(jax.random.PRNGKey(7))
    for _ in range(3):
        state = s.step(state)
    return state


def _spawn_pod(tmp_path, mode):
    with socket.socket() as sock:  # pick a free coordinator port
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    child = os.path.join(os.path.dirname(__file__), "multihost_child.py")
    env = dict(os.environ, MULTIHOST_MODE=mode)
    # children configure their own platform/devices (2 CPU devs/process)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, child, str(pid), "2", str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"fake-pod child failed:\n{out}"
    return [np.load(os.path.join(tmp_path, f"child{pid}_{mode}.npz"))
            for pid in range(2)]


@pytest.mark.multiprocess
def test_two_process_pod_equals_single_process(tmp_path):
    """2 processes x 2 CPU devices == 1 process x 4 CPU devices, same
    (2, 2) mesh: identical chains (labels exact; floats to reassociation
    tolerance -- gloo all-reduce may order sums differently)."""
    ref = _single_process_reference()
    c0, c1 = _spawn_pod(tmp_path, "global")
    # the two pod processes must agree exactly with each other
    np.testing.assert_array_equal(c0["labels"], c1["labels"])
    np.testing.assert_array_equal(c0["beta"], c1["beta"])
    np.testing.assert_array_equal(c0["eps"], c1["eps"])
    # and with the single-process chain
    np.testing.assert_array_equal(np.asarray(ref.labels), c0["labels"])
    np.testing.assert_allclose(np.asarray(ref.beta), c0["beta"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.eps), c0["eps"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ref.sigmaE), float(c0["sigmaE"]),
                               rtol=1e-5)


@pytest.mark.multiprocess
def test_pod_with_per_host_marker_slabs(tmp_path):
    """x_process_shard: each host passes only its own marker rows; the
    chain must match the single-process full-X chain."""
    ref = _single_process_reference()
    c0, c1 = _spawn_pod(tmp_path, "shard")
    np.testing.assert_array_equal(c0["labels"], c1["labels"])
    np.testing.assert_array_equal(np.asarray(ref.labels), c0["labels"])
    np.testing.assert_allclose(np.asarray(ref.beta), c0["beta"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.eps), c0["eps"],
                               rtol=1e-5, atol=1e-5)


def test_bed_marker_range_reads():
    """Per-host .bed slab reads: slices of the packed words equal the rows
    of a full read (feeds multi-host x_process_shard loading)."""
    from bayesrrcpp_tpu.io import bed

    rng = np.random.default_rng(5)
    N, M = 37, 23  # deliberately non-multiples of 4/16
    dosage = rng.binomial(2, 0.4, size=(N, M)).astype(float)
    dosage[rng.random((N, M)) < 0.05] = np.nan
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "toy")
        bed.write_bed(prefix, dosage)
        full = bed.read_bed_packed(prefix)
        for m0, m1 in [(0, M), (0, 7), (7, 23)]:
            part = bed.read_bed_packed(prefix, marker_range=(m0, m1))
            np.testing.assert_array_equal(full.words[m0:m1], part.words)
            np.testing.assert_allclose(full.means[m0:m1], part.means)
            np.testing.assert_allclose(full.sds[m0:m1], part.sds)
            assert part.n == N
            assert list(part.snp_ids) == list(full.snp_ids[m0:m1])
