"""Fake-pod child process for tests/test_multihost.py.

Joins a 2-process CPU cluster (2 virtual devices per process -> a global
(2, 2) ("m", "n") mesh), runs a few sharded BayesR iterations on
deterministic simulated data, and writes the replicated final state to an
.npz for the parent to compare against the single-process chain.

Usage: python multihost_child.py <process_id> <num_processes> <port> <outdir>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    import jax  # noqa: E402  (config still mutable before backend init)

    from bayesrrcpp_tpu.parallel import distributed as dx

    dx.initialize(f"localhost:{port}", nproc, pid, platform="cpu",
                  cpu_devices_per_process=2)
    # match tests/conftest.py (the parent comparison chain runs under x64;
    # hyperparameter draws would otherwise happen at different precision)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from bayesrrcpp_tpu import GroupsConfig
    from bayesrrcpp_tpu.parallel.sharded import ShardedSpikeSlabSampler
    from tests.test_multihost import make_problem

    mesh = dx.global_mesh(2, 2)
    X, Y, cva, g_assign = make_problem()

    mode = os.environ.get("MULTIHOST_MODE", "global")
    kw = {}
    if mode == "shard":
        # per-host marker slab: each process passes only its own rows
        M = X.shape[1]
        B = 16
        Mpad = -(-M // (B * 2)) * (B * 2)  # same formula as the sampler (Dm=2)
        lo, hi = dx.process_marker_range(mesh, Mpad)
        m_real = max(0, min(hi, M) - lo)
        kw = dict(x_process_shard=True, n_markers=M, transposed=True)
        X = np.ascontiguousarray(X.T)[lo:lo + m_real]
    s = ShardedSpikeSlabSampler(X, Y, cva, GroupsConfig(block_size=16), mesh,
                                g_assign=g_assign,
                                dtype=jnp.float32, **kw)
    state = s.init(jax.random.PRNGKey(7))
    for _ in range(3):
        state = s.step(state)
    rep = dx.replicate(state, mesh)
    np.savez(os.path.join(outdir, f"child{pid}_{mode}.npz"),
             beta=np.asarray(rep.beta), eps=np.asarray(rep.eps),
             labels=np.asarray(rep.labels), sigmaE=np.asarray(rep.sigmaE),
             pi=np.asarray(rep.pi))
    print(f"child {pid} ok", flush=True)


if __name__ == "__main__":
    main()
