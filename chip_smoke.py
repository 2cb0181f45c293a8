"""Smoke run of the BFB engine on the GPU, through the entry points a
user calls, at the widths users run.

    python chip_smoke.py             # one card: phases 0-5
    python chip_smoke.py --cards 4   # four cards: the run_bfb_many mesh
                                     # path and its cross-check, nothing else

Every phase prints one line with its result, wall seconds and compile
seconds; any failure exits non-zero. The card's `nvidia-smi` name and
power limit are printed before the last line, which is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU the script fails at phase 0; it never falls back to the
CPU. Full compiled HLO of the scorer goes under chiprun_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

from ambigram_tpu.utils.cache import enable_compilation_cache
from ambigram_tpu.utils.device import nvidia_smi_name_power, require_gpu

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
GOLDEN_EGFR6 = (
    "1+2+3+4+5+6+|6-5-4-3-2-|2+3+4+|4-3-|3+4+|4-3-2-|2+3+4+5+6+|6-5-4-3-2-1-"
)
COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
# f32 (24-bit significand) holds every multiple of 0.5 below 2^23, so
# partial sums of half-integer hinge terms are exact up to there
F32_EXACT_LIMIT = 2.0**23


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its own
    monitoring events."""

    def __init__(self) -> None:
        import threading

        import jax

        self.seconds = 0.0
        self._lock = threading.Lock()  # the batch pipeline compiles on threads
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event in COMPILE_EVENTS:
            with self._lock:
                self.seconds += duration


@contextlib.contextmanager
def phase(name: str, clock: CompileClock):
    """Time one phase; print its result line. An exception propagates
    after a FAILED line, so a failed phase fails the run."""
    t0, c0 = time.perf_counter(), clock.seconds
    info: dict = {}
    result = "FAILED"
    try:
        yield info
        result = "ok"
    finally:
        print(
            "phase %s: %s  %s  wall %.1f s  compile %.1f s"
            % (
                name,
                result,
                "  ".join("%s=%s" % kv for kv in info.items()),
                time.perf_counter() - t0,
                clock.seconds - c0,
            ),
            flush=True,
        )


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device(devices) -> dict:
    """Phase 0: the devices must be GPUs (raises otherwise) — then
    describe them."""
    import jax

    require_gpu(devices)
    return {
        "kind": repr(devices[0].device_kind),
        "count": len(devices),
        "jax": jax.__version__,
        "compile_cache": repr(enable_compilation_cache()),
        "nvidia_smi": repr(nvidia_smi_name_power()),
    }


# ------------------------------------------------------------- phase 1


def phase_golden() -> dict:
    from ambigram_tpu.engine.pipeline import run_bfb

    lh = os.path.join(REPO, "tests", "data", "egfr6.lh")
    for solver in ("device", "auto"):
        res = run_bfb(lh, solver=solver)
        check(
            res.path_strings == [GOLDEN_EGFR6],
            "%s path %r != golden" % (solver, res.path_strings),
        )
    return {"egfr6": "byte-equal (device, auto)"}


# ------------------------------------------------------------- phase 2


def reference_scores(prog, X: np.ndarray) -> np.ndarray:
    """The repo's f64 objective: residual + PENALTY * violation."""
    from ambigram_tpu.solver.score import PENALTY

    x = X[:, : prog.num_vars].astype(np.float64)
    return prog.residual_objective(x) + PENALTY * prog.hard_violation(x)


def small_candidates(prog, Vp: int, n: int, seed: int) -> np.ndarray:
    """Search-like candidates within int8: the population seeds, the
    greedy peel, and sparse random loop/pattern counts — up to 12
    entries below 16, or up to 2 entries up to 127 (many large entries
    violate hard rows by more than f32 can sum exactly)."""
    from ambigram_tpu.solver.search import _seed_population, greedy_peel_seed

    x_ub = np.zeros(Vp, np.float32)
    x_ub[: prog.num_vars] = prog.x_ub
    X = np.zeros((n, Vp), np.float32)
    X[:32] = _seed_population(prog, Vp, x_ub, pop=32, seed=seed)
    X[3, : prog.num_vars] = np.minimum(greedy_peel_seed(prog), prog.x_ub)
    rng = np.random.default_rng(seed)
    for b in range(32, n):
        k, top = (int(rng.integers(1, 13)), 16) if b % 2 else (int(rng.integers(1, 3)), 128)
        idx = rng.choice(prog.num_vars, size=k, replace=False)
        X[b, idx] = rng.integers(1, top, size=k)
    return np.minimum(X, x_ub)


def large_candidates(prog, Vp: int) -> np.ndarray:
    """One entry above 2048 (odd, so TF32 would round it) on the
    patterns/loops spanning nearly the whole interval — the only
    variables whose large values keep the score below 2^23."""
    T = len(prog.pairs)
    span = [
        t
        for t, (i, j) in enumerate(prog.pairs)
        if i - prog.start <= 2 and prog.end - j <= 2
    ]
    variables = span + [T + t for t in span]
    values = 2049.0 + 58.0 * np.arange(16)  # odd, 2049..2919
    X = np.zeros((len(variables) * len(values), Vp), np.float32)
    rows = np.arange(len(X))
    X[rows, np.repeat(variables, len(values))] = np.tile(values, len(variables))
    return X


def dot_lowering(hlo: str) -> str:
    """What XLA made of the dots: library/Triton GEMM calls, or plain
    dot instructions left for XLA's own emitters."""
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    gemm = [t for t in targets if re.search(r"gemm|matmul|cublas", t, re.I)]
    return "targets=%s triton_gemm=%s plain_dots=%d" % (
        gemm or "none",
        "yes" if "__triton_gemm" in hlo else "no",
        len(re.findall(r"\bdot\(", hlo)),
    )


def _median_ms(f, *args, reps: int = 20) -> float:
    f(*args).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(*args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def scorer_parity(prog, n_small: int, label: str, time_pin: bool) -> dict:
    """score_batch on the device against the f64 reference, tolerance 0,
    on the int8 path (x <= 127) and on the f32 path (a copy whose loop
    box is raised past 2048)."""
    import jax
    import jax.numpy as jnp

    from ambigram_tpu.solver.score import row_values, score_batch, scoring_tensors

    info: dict = {"V": prog.num_vars}
    p8 = dataclasses.replace(prog, x_ub=np.minimum(prog.x_ub, 127.0))
    st8 = scoring_tensors(p8)
    check(st8.use_int8, "%s: int8 path not taken" % label)
    Vp = st8.H.shape[1]
    info["rows"] = st8.H.shape[0]
    X8 = small_candidates(p8, Vp, n_small, seed=1)
    want8 = reference_scores(p8, X8)
    keep = want8 < F32_EXACT_LIMIT
    check(keep.sum() >= n_small // 2, "%s: too few int8 candidates below 2^23" % label)
    score = jax.jit(score_batch)
    got8 = np.asarray(score(st8, X8[keep]))
    bad = int((got8 != want8[keep]).sum())
    check(bad == 0, "%s int8: %d of %d scores differ" % (label, bad, keep.sum()))
    info["int8_exact"] = int(keep.sum())
    hlo = {"int8": score.lower(st8, X8[keep]).compile().as_text()}
    info["int8_dot"] = dot_lowering(hlo["int8"])

    pf = dataclasses.replace(prog, x_ub=np.full_like(prog.x_ub, 4096.0))
    stf = scoring_tensors(pf)
    check(not stf.use_int8, "%s: f32 path not taken" % label)
    XL = large_candidates(pf, Vp)
    wantL = reference_scores(pf, XL)
    keepL = wantL < F32_EXACT_LIMIT
    check(keepL.sum() >= 16, "%s: too few large candidates below 2^23" % label)
    Xf = np.concatenate([XL[keepL], X8[keep]])
    wantf = np.concatenate([wantL[keepL], reference_scores(pf, X8[keep])])
    gotf = np.asarray(score(stf, Xf))
    bad = int((gotf != wantf).sum())
    check(bad == 0, "%s f32: %d of %d scores differ" % (label, bad, len(Xf)))
    info["f32_exact"] = "%d (%d above 2048)" % (len(Xf), int(keepL.sum()))
    # the row values themselves: what TF32 operand rounding would change
    H64 = np.asarray(stf.H).astype(np.float64)
    hx_ref = XL[keepL].astype(np.float64) @ H64.T
    hx = np.asarray(jax.jit(row_values)(XL[keepL], stf.H))
    check(np.abs(hx_ref).max() < F32_EXACT_LIMIT, "%s: hx reference beyond 2^23" % label)
    check(np.array_equal(hx, hx_ref), "%s: pinned row values differ" % label)
    default_dot = jax.jit(
        lambda x, H: jnp.matmul(x, H.T, preferred_element_type=jnp.float32)
    )
    hx_def = np.asarray(default_dot(XL[keepL], stf.H))
    info["default_precision_rows_off"] = int((hx_def != hx_ref).any(axis=1).sum())
    lowered = score.lower(stf, Xf)
    info["f32_precision"] = "/".join(
        sorted(set(re.findall(r"precision = \[(\w+), \w+\]", lowered.as_text())))
    )
    hlo["f32"] = lowered.compile().as_text()
    info["f32_dot"] = dot_lowering(hlo["f32"])
    os.makedirs(OUT_DIR, exist_ok=True)
    for path, text in hlo.items():
        with open(os.path.join(OUT_DIR, "hlo_score_%s_%s.txt" % (path, label)), "w") as f:
            f.write(text)
    if time_pin:
        for B in (32, 8192):
            Xb = jax.device_put(np.resize(X8, (B, Vp)))
            hi = _median_ms(jax.jit(row_values), Xb, stf.H)
            lo = _median_ms(default_dot, Xb, stf.H)
            info["pin_ms_B%d" % B] = "%.3f_vs_default_%.3f" % (hi, lo)
    return info


def phase_scorer(sizes=((48, 1024, True), (96, 256, False))) -> dict:
    """(segments, int8 candidates, time the pinned dot) per program."""
    from __graft_entry__ import _demo_program

    info = {}
    for S, n_small, time_pin in sizes:
        for k, v in scorer_parity(_demo_program(S), n_small, "S%d" % S, time_pin).items():
            info["S%d_%s" % (S, k)] = v
    return info


# ------------------------------------------------------------- phase 3


def sweep_lockstep(prog, sweeps: int = 4) -> int:
    """`_sweep_delta` against the materializing `_sweep`: scores, X and
    hx bitwise equal after every sweep. Returns the sweeps compared."""
    import jax.numpy as jnp

    from ambigram_tpu.solver.score import row_values, scoring_tensors
    from ambigram_tpu.solver.search import (
        _score_from_hx,
        _seed_population,
        _sweep,
        _sweep_delta,
    )

    st = scoring_tensors(prog)
    X = jnp.asarray(
        _seed_population(prog, st.H.shape[1], np.asarray(st.x_ub), pop=8, seed=3)
    )
    hx = row_values(X, st.H)
    scores = _score_from_hx(st, hx)
    Xa, sa = X, scores
    Xb, hxb, sb = X, hx, scores
    for n in range(1, sweeps + 1):
        Xa, sa, imp_a = _sweep(st, Xa, sa)
        Xb, hxb, sb, imp_b = _sweep_delta(st, Xb, hxb, sb)
        check(bool(imp_a) == bool(imp_b), "lockstep: improved flags differ")
        check(np.array_equal(np.asarray(sa), np.asarray(sb)), "lockstep: scores differ")
        check(np.array_equal(np.asarray(Xa), np.asarray(Xb)), "lockstep: X differs")
        check(
            np.array_equal(np.asarray(hxb), np.asarray(row_values(Xb, st.H))),
            "lockstep: threaded hx differs from a fresh product",
        )
        if not bool(imp_a):
            return n
    return sweeps


def phase_search(S: int = 48) -> dict:
    from __graft_entry__ import _demo_program
    from ambigram_tpu.scripts.simulate import random_bfb_program
    from ambigram_tpu.solver.exact import solve_exact
    from ambigram_tpu.solver.search import solve_device

    prog = _demo_program(S)
    info = {"lockstep_int8_S%d" % S: sweep_lockstep(prog)}
    pf = dataclasses.replace(prog, x_ub=np.full_like(prog.x_ub, 4096.0))
    info["lockstep_f32_S%d" % S] = sweep_lockstep(pf)
    gaps = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        p = random_bfb_program(rng, int(rng.integers(4, 8)))
        ex = solve_exact(p)
        check(ex.status == "optimal", "random %d: exact not optimal" % seed)
        dev = solve_device(p)
        check(
            float(p.hard_violation(dev.x.astype(float))) == 0.0,
            "random %d: device solution infeasible" % seed,
        )
        gap = abs(dev.epsilon_sum - ex.epsilon_sum)
        check(gap <= 1e-6, "random %d: eps %g vs exact %g" % (seed, dev.epsilon_sum, ex.epsilon_sum))
        gaps.append(gap)
    info["device_vs_exact_max_gap"] = max(gaps)
    return info


# ------------------------------------------------------------- phase 4


def write_cohort(workdir: str, sizes=(32, 48), n_cases: int = 16) -> list:
    """The 16 cases bench.py's batch leg simulates: S32/S48 alternating,
    noise 0.05, process mode, seeds 200-215."""
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    paths = []
    for i in range(n_cases):
        case = simulate_bfb_case(
            seed=200 + i,
            n_segments=sizes[i % 2],
            rounds=5,
            mode="process",
            noise=0.05,
        )
        paths.append(write_case(case, os.path.join(workdir, "b%d" % i))["lh"])
    return paths


@contextlib.contextmanager
def recorded_solutions():
    """Record every (program, solution) the batch pipeline returns, so
    feasibility is checked on the solutions themselves, not on printed
    paths (an infeasible chromosome still prints its trivial path)."""
    from ambigram_tpu.engine import pipeline

    seen: list = []
    batch, single = pipeline.solve_programs_batch, pipeline._solve

    def rec_batch(flat, index, **kw):
        sols = batch(flat, index, **kw)
        by_key = dict(zip(index, flat))
        seen.extend((by_key[k], s) for k, s in sols.items())
        return sols

    def rec_single(prog, solver, **kw):
        sol = single(prog, solver, **kw)
        seen.append((prog, sol))
        return sol

    pipeline.solve_programs_batch, pipeline._solve = rec_batch, rec_single
    try:
        yield seen
    finally:
        pipeline.solve_programs_batch, pipeline._solve = batch, single


def all_feasible(seen) -> bool:
    return bool(seen) and all(
        s is not None
        and s.status in ("optimal", "heuristic")
        and float(p.hard_violation(s.x.astype(np.float64))) == 0.0
        for p, s in seen
    )


def cli_wave(manifest: str, store: str, solver: str, n_cases: int) -> dict:
    """One `--manifest` CLI run in this process (a second JAX process
    could not get the card's memory)."""
    from ambigram_tpu import cli

    stdout = io.StringIO()
    t0 = time.perf_counter()
    with recorded_solutions() as seen, contextlib.redirect_stdout(stdout):
        rc = cli.main(
            [
                "--op", "bfb", "--in_lh", manifest, "--manifest",
                "--result_store", store, "--solver", solver, "--no-ledgers",
            ]
        )
    secs = time.perf_counter() - t0
    check(rc == 0, "cli %s returned %d" % (solver, rc))
    stored = []
    for name in sorted(os.listdir(store)):
        with open(os.path.join(store, name)) as f:
            stored.append(json.load(f))
    check(len(stored) == n_cases, "cli %s stored %d results" % (solver, len(stored)))
    check(
        all(r["path_strings"] and all(r["path_strings"]) for r in stored),
        "cli %s: a case has an empty path" % solver,
    )
    check(all_feasible(seen), "cli %s: a solution violates hard rows" % solver)
    return {
        "seconds": round(secs, 2),
        "cases_per_min": round(60.0 * n_cases / secs, 2),
        "eps_sum": round(sum(r["ilp_error"] for r in stored), 4),
    }


def phase_cohort(workdir: str, **cohort) -> dict:
    paths = write_cohort(workdir, **cohort)
    manifest = os.path.join(workdir, "cohort.manifest")
    with open(manifest, "w") as f:
        f.write("\n".join(paths) + "\n")
    info = {}
    # device twice: its first wave compiles every search shape, the
    # second shows the warm rate; auto's time is host exact-stage
    # budgets (minutes), so it runs once, after the compiles
    for solver, wave in (("device", 1), ("device", 2), ("auto", 1)):
        store = os.path.join(workdir, "store_%s_%d" % (solver, wave))
        leg = cli_wave(manifest, store, solver, len(paths))
        for k, v in leg.items():
            info["%s_wave%d_%s" % (solver, wave, k)] = v
    return info


# ------------------------------------------------------------- phase 5


def phase_widest(workdir: str, n_segments: int = 96) -> dict:
    from ambigram_tpu.engine.pipeline import run_bfb
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    case = simulate_bfb_case(
        seed=300 + n_segments,
        n_segments=n_segments,
        rounds=6,
        mode="process",
        noise=0.05,
    )
    lh = write_case(case, os.path.join(workdir, "big%d" % n_segments))["lh"]
    with recorded_solutions() as seen:
        res = run_bfb(lh, solver="device")
    check(all_feasible(seen), "S%d: solution violates hard rows" % n_segments)
    check(
        res.path_strings and all(res.path_strings)
        and not any(c.infeasible for c in res.chromosomes),
        "S%d: no path" % n_segments,
    )
    return {
        "V": max(p.num_vars for p, _ in seen),
        "eps": round(res.ilp_error, 4),
        "status": "/".join(s.status for _, s in seen),
    }


# ------------------------------------------------------------- 4 cards


def phase_mesh(workdir: str, **cohort) -> dict:
    """run_bfb_many over a 4-card mesh: the default (case, model) = (2, 2)
    grid (per-case searches round-robin over the cards, the stacked
    sharded pass with its psum), then a (1, 4) grid whose single case
    slot sends the whole cohort through one case-stacked leg per card.
    Per-card evidence: the searches each card was handed and its peak
    memory."""
    import jax

    from ambigram_tpu.engine.pipeline import run_bfb_many
    from ambigram_tpu.parallel.mesh import make_mesh
    from ambigram_tpu.solver import search

    paths = write_cohort(workdir, **cohort)
    legs: dict = {}
    single, batch = search.solve_device, search.solve_device_batch

    def rec_single(prog, device=None, **kw):
        legs.setdefault(getattr(device, "id", "default"), []).append("single")
        return single(prog, device=device, **kw)

    def rec_batch(progs, device=None, **kw):
        legs.setdefault(getattr(device, "id", "default"), []).append(
            "batch%d" % len(progs)
        )
        return batch(progs, device=device, **kw)

    info = {}
    search.solve_device, search.solve_device_batch = rec_single, rec_batch
    try:
        for name, mesh in (("mesh2x2", make_mesh(4)), ("mesh1x4", make_mesh(4, case_axis=1))):
            legs.clear()
            t0 = time.perf_counter()
            with recorded_solutions() as seen:
                results = run_bfb_many(paths, solver="device", mesh=mesh)
            secs = time.perf_counter() - t0
            check(all(r.path_strings and all(r.path_strings) for r in results), "%s: empty path" % name)
            check(all_feasible(seen), "%s: a solution violates hard rows" % name)
            info[name + "_seconds"] = round(secs, 2)
            info[name + "_eps_sum"] = round(sum(r.ilp_error for r in results), 4)
            info[name + "_legs"] = json.dumps(
                {str(k): v for k, v in sorted(legs.items(), key=lambda kv: str(kv[0]))}
            ).replace(" ", "")
        cards_used = sorted(k for k in legs if k != "default")
        check(cards_used == [d.id for d in jax.devices()[:4]], "mesh1x4 legs on %s" % cards_used)
    finally:
        search.solve_device, search.solve_device_batch = single, batch
    info["peak_GB_per_card"] = "/".join(
        "%.2f" % ((d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 1e9)
        for d in jax.devices()
    )
    return info


def phase_sharded_vs_single(workdir: str) -> dict:
    """The small case through the stacked sharded pass on the 4-card
    mesh must equal `solve_device` on one card within 1e-6."""
    from ambigram_tpu.engine.pipeline import extract_programs, run_bfb_many
    from ambigram_tpu.parallel.mesh import make_mesh
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case
    from ambigram_tpu.solver.search import solve_device

    case = simulate_bfb_case(seed=0, n_segments=8, mode="nested")
    lh = write_case(case, os.path.join(workdir, "small"))["lh"]
    sharded = run_bfb_many([lh], solver="device", mesh=make_mesh(4))[0].ilp_error
    single = solve_device(extract_programs(lh)[0]).objective
    check(abs(sharded - single) <= 1e-6, "sharded %g != single %g" % (sharded, single))
    return {"sharded": sharded, "single_card": single}


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--cards",
        type=int,
        default=1,
        choices=(1, 4),
        help="4 runs the multi-card run_bfb_many path and its cross-check only",
    )
    args = ap.parse_args(argv)

    import jax

    clock = CompileClock()
    devices = jax.devices()
    with phase("0-device", clock) as info:
        info.update(phase_device(devices))
        check(len(devices) >= args.cards, "%d cards needed" % args.cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.cards == 4:
            with phase("mesh-4-cards", clock) as info:
                info.update(phase_mesh(workdir))
            with phase("sharded-vs-single", clock) as info:
                info.update(phase_sharded_vs_single(workdir))
        else:
            with phase("1-golden", clock) as info:
                info.update(phase_golden())
            with phase("2-scorer-parity", clock) as info:
                info.update(phase_scorer())
            with phase("3-search-parity", clock) as info:
                info.update(phase_search())
            with phase("4-cohort-cli", clock) as info:
                info.update(phase_cohort(workdir))
            with phase("5-widest-S96", clock) as info:
                info.update(phase_widest(workdir))
    print("nvidia-smi: %s" % nvidia_smi_name_power(), flush=True)
    d = devices[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": d.platform,
                    "kind": d.device_kind,
                    "count": len(devices),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
