"""Weak-scaling proxy: orchestration + collective overhead vs mesh size.

This proxy measures the sharding machinery itself, not device scaling:
it runs the SAME stacked case-sharded pass
(parallel.mesh.solve_cases_sharded — the batch pipeline's device stage)
over virtual CPU meshes of 1/2/4/8 devices on CONSTANT physical
hardware. The compute resource does not change, so
the ideal result is a flat wall time; any slowdown vs the 1-device run
is the cost of mesh partitioning, shard_map dispatch, and the psum
collectives — the only component of multi-chip scaling efficiency this
environment can observe (BASELINE.md "scaling efficiency" line;
replaces the reference's serial loop, localhap.cpp:111-265).

Run as a subprocess (fresh interpreter) per mesh size because the
device count is fixed at backend initialization:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python -m ambigram_tpu.scripts.scaling_proxy \
        --cases <dir-with-lh-files> --mesh 4

Prints one JSON line: {"mesh": N, "seconds": t,
"compile_plus_first_run_seconds": c, "eps_sum": e, "solved": k,
"n_programs": n}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def run_proxy(case_dir: str, mesh_size: int) -> dict:
    import numpy as np

    from ambigram_tpu.engine.pipeline import extract_programs
    from ambigram_tpu.parallel.mesh import make_mesh, solve_cases_sharded

    lh_paths = sorted(glob.glob(os.path.join(case_dir, "*.lh")))
    progs = []
    for p in lh_paths:
        progs += [pr for pr in extract_programs(p) if pr is not None]
    mesh = make_mesh(mesh_size)
    # Warm-up must run the IDENTICAL call: jit caches by shape, so a
    # cut-down warm-up (1 program, tiny budgets) compiles a DIFFERENT
    # executable and the measured wall still pays the full XLA compile
    # — which is largest and most run-to-run variable for the 1-device
    # layout (one shard holds all stacked cases), and was the whole
    # "mesh1 slowest" anomaly (r4 weak #6: readings swung between -18%
    # and -54% depending on how slow that compile happened to be).
    t0 = time.perf_counter()
    solve_cases_sharded(progs, mesh=mesh)
    compile_plus_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    best = solve_cases_sharded(progs, mesh=mesh)
    seconds = time.perf_counter() - t0
    eps = 0.0
    solved = 0
    for prog, x in zip(progs, best):
        if float(prog.hard_violation(x.astype(np.float64))) == 0.0:
            eps += float(prog.residual_objective(x.astype(np.float64)))
            solved += 1
    return {
        "mesh": mesh_size,
        "seconds": round(seconds, 2),
        "compile_plus_first_run_seconds": round(compile_plus_first, 2),
        "eps_sum": round(eps, 2),
        "solved": solved,
        "n_programs": len(progs),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", required=True)
    ap.add_argument("--mesh", type=int, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(run_proxy(args.cases, args.mesh)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
