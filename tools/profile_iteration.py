"""Trace one BayesR iteration at the biobank shape and split its device time.

    python tools/profile_iteration.py [--out profile_iteration.json]

Builds the 2-bit N=100,352 x M=503,808 sampler of ``chip_smoke.py``, runs
two warm iterations, then traces one with ``jax.profiler``.  The step runs
as CUDA graphs, whose kernels carry no scope metadata, so device events
are attributed by name and count: the X-pass kernels (``packed_x*``), the
solve loop (kernels that run once per dependent solve step or more, i.e.
at least rounds * B times), and everything else.  Prints the iteration's
wall time, device busy time and idle share, and each part's kernel time;
writes the top events to the JSON file.
"""
import argparse
import glob
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path, solve_steps):
    """Device kernel time by part from an .xplane.pb file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    by_name, spans, sample = {}, [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                n, t = by_name.get(ev.name, (0, 0))
                by_name[ev.name] = (n + 1, t + ev.duration_ns)
                spans.append((ev.start_ns, ev.end_ns))
                if len(sample) < 5:
                    sample.append({"name": ev.name,
                                   "stats": [(k, str(v)[:200])
                                             for k, v in ev.stats]})
    by_part = {"xpass": 0, "solve": 0, "other": 0}
    for name, (n, t) in by_name.items():
        part = ("xpass" if name.startswith("packed_x")
                else "solve" if n >= solve_steps else "other")
        by_part[part] += t
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    return {"window_ns": window, "busy_ns": _union_ns(spans),
            "part_ns": by_part,
            "top_events": [{"name": k, "count": n, "ns": t}
                           for k, (n, t) in top],
            "sample_events": sample}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_iteration.json")
    args = ap.parse_args()

    import jax
    import numpy as np

    from bayesrrcpp_tpu import BayesRConfig, SpikeSlabSampler
    from bayesrrcpp_tpu.utils.device import card_info
    from chip_smoke import CVA, biobank_inputs

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_iteration needs a GPU")
    XT, Y, stats = biobank_inputs(jax)
    smp = SpikeSlabSampler(XT, Y, np.array(CVA), BayesRConfig(),
                           transposed=True, x_dtype="2bit", x_stats=stats)
    st = smp.init(jax.random.PRNGKey(1))
    for _ in range(2):
        st = jax.block_until_ready(smp._run_steps(st, smp.data, 1))
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        with jax.profiler.trace(td):
            st = jax.block_until_ready(smp._run_steps(st, smp.data, 1))
        wall = time.perf_counter() - t0
        res = reduce_trace(glob.glob(os.path.join(
            td, "plugins", "profile", "*", "*.xplane.pb"))[0],
            solve_steps=smp.nb // smp.jacobi * smp.B)
    res.update(wall_ms_traced=1e3 * wall, card=card_info(),
               J=smp.jacobi, B=smp.B)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    ms = lambda ns: ns / 1e6
    sc = res["part_ns"]
    print(f"traced iteration: wall {1e3 * wall:.1f} ms, device window "
          f"{ms(res['window_ns']):.1f} ms, busy {ms(res['busy_ns']):.1f} ms "
          f"(idle share {1 - res['busy_ns'] / res['window_ns']:.3f}); "
          f"xpass {ms(sc['xpass']):.1f} ms, solve {ms(sc['solve']):.1f} ms, "
          f"other {ms(sc['other']):.1f} ms of kernel time [{res['card']}]")
    for e in res["top_events"][:10]:
        print(f"  {e['ns'] / 1e6:9.2f} ms  x{e['count']:6d}  {e['name'][:90]}")


if __name__ == "__main__":
    main()
