"""Golden-diff suite over the BASELINE configuration list.

Runs every configuration class from /root/repo/BASELINE.md through the
full pipeline and diffs outputs against expectations:

1. bundled 6-segment chr7/EGFR case (reference README golden string)
2. simulated PE-WGS BFB cases, 10-30 segments (exact truth recovery)
3. multi-chromosome + translocation (PROP C2 merge)
4. 10x linked-read JUNCS evidence
5. long-read JUNCS + virus integration (PROP I1)

Usage:  python -m ambigram_tpu.scripts.golden_suite [--solver exact|device|auto]
Prints a JSON report; exit code 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List


GOLDEN_EGFR6 = (
    "1+2+3+4+5+6+|6-5-4-3-2-|2+3+4+|4-3-|3+4+|4-3-2-|2+3+4+5+6+|6-5-4-3-2-1-"
)

# The reference README's published expected outputs for the four TRX
# modes (/root/reference/README.md:132-167), byte-for-byte.
README_TRX_GOLDENS = [
    (
        "i1",
        "readme_i1.lh",
        "1+2+3+||6+||4+|4-||6-||3-2-|2+3+||6+||4+|4-||6-||3-2-",
        "path",
    ),
    (
        "i2",
        "readme_i2.lh",
        "1+2+3+||5+6+7+|7-6-||8+9+||4-3-2-|2+3+4+|4-3-",
        "merged",
    ),
    (
        "c1",
        "readme_c1.lh",
        "TRX-BFB mode: BFB path in the first stage:\n"
        "8+||2+3+4+5+|7-6-5-4-3-2-||8-|8+||2+3+4+5+|7-6-5-4-3-2-|2+3+4+5+\n"
        "TRX-BFB mode: BFB path in the second stage:\n"
        "10-||4+5+|7-6-5-4-3-2-||8-|8+||2+3+4+5+|7-6-5-4-3-2-|2+3+4+5+\n",
        "console",
    ),
    (
        "c2",
        "readme_c2.lh",
        "1+2+3+4+|4-3-2-|2+3+||6+7+|7-6-|6+7+|7-6-5-",
        "merged",
    ),
]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DATA = os.path.join(_REPO, "tests", "data")


def run_suite(solver: str = "exact", workdir: str | None = None) -> Dict:
    from ambigram_tpu.engine.pipeline import run_bfb
    from ambigram_tpu.scripts.evaluate import junction_score, multiplicity_diff
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    workdir = workdir or tempfile.mkdtemp(prefix="golden_suite_")
    cwd = os.getcwd()
    os.chdir(workdir)
    checks: List[Dict] = []

    def record(name, ok, seconds, detail=""):
        checks.append(
            {"name": name, "ok": bool(ok), "seconds": round(seconds, 3), "detail": detail}
        )

    try:
        # 1. bundled EGFR
        t0 = time.perf_counter()
        res = run_bfb(os.path.join(_DATA, "egfr6.lh"), solver=solver)
        record(
            "egfr6_golden",
            res.path_strings[0] == GOLDEN_EGFR6,
            time.perf_counter() - t0,
            res.path_strings[0],
        )

        # 2. simulated PE-WGS cases, 10-30 segments
        for n in (10, 16, 22, 30):
            case = simulate_bfb_case(seed=n, n_segments=n)
            paths = write_case(case, "pe%d" % n)
            t0 = time.perf_counter()
            res = run_bfb(paths["lh"], solver=solver)
            diff = multiplicity_diff(case.truth_string, res.path_strings[0])
            score = junction_score(case.truth_string, res.path_strings[0])
            record(
                "pe_wgs_n%d" % n,
                diff == 0 and score.recall == 1.0,
                time.perf_counter() - t0,
                "mult_diff=%d recall=%.2f" % (diff, score.recall),
            )

        # 3. multi-chromosome + translocation (PROP C2)
        t0 = time.perf_counter()
        res = run_bfb(os.path.join(_DATA, "c2_twochrom.lh"), solver=solver)
        merged = res.merged_path_string
        record(
            "multichrom_c2",
            "3+||6+" in merged and merged.endswith("6+7+8+"),
            time.perf_counter() - t0,
            merged,
        )

        # 4. 10x linked-read JUNCS evidence
        case = simulate_bfb_case(seed=8, n_segments=8, n_juncs_fragments=5)
        paths = write_case(case, "tenx")
        t0 = time.perf_counter()
        res = run_bfb(paths["lh"], juncs_path=paths["juncs"], juncs_info=True, solver=solver)
        diff = multiplicity_diff(case.truth_string, res.path_strings[0])
        record(
            "tenx_juncs",
            diff == 0,
            time.perf_counter() - t0,
            "mult_diff=%d" % diff,
        )

        # 5. virus integration (PROP I1) + long-read JUNCS
        t0 = time.perf_counter()
        res = run_bfb(os.path.join(_DATA, "i1_virus.lh"), solver=solver)
        p = res.path_strings[0]
        record(
            "virus_i1",
            "2+||5+" in p and "6+||3+" in p,
            time.perf_counter() - t0,
            p,
        )

        # 5b. simulated virus integration: generated I1 cases with known
        # truth (not just the hand-made fixture) — reference analog is
        # the simu.py mutforge pipeline (script/simu.py:278-316)
        from ambigram_tpu.scripts.simulate import simulate_virus_case

        for seed in (0, 1):
            case = simulate_virus_case(seed=seed, n_host=6, n_virus=2)
            paths = write_case(case, "vi%d" % seed)
            t0 = time.perf_counter()
            res = run_bfb(paths["lh"], solver=solver)
            diff = multiplicity_diff(case.truth_string, res.path_strings[0])
            score = junction_score(case.truth_string, res.path_strings[0])
            record(
                "virus_i1_sim%d" % seed,
                diff == 0 and score.recall == 1.0 and "||" in res.path_strings[0],
                time.perf_counter() - t0,
                "mult_diff=%d recall=%.2f" % (diff, score.recall),
            )

        # 6. post-BFB insertion (PROP I2) — all four TRX modes covered
        t0 = time.perf_counter()
        res = run_bfb(os.path.join(_DATA, "i2_insert.lh"), solver=solver)
        merged = res.merged_path_string
        record(
            "insert_i2",
            merged == "1+2+3+||5+6+||4+|4-3-2-|2+3+4+",
            time.perf_counter() - t0,
            merged,
        )

        # 7. pre-BFB concatenation (PROP C1) with second-stage SV
        t0 = time.perf_counter()
        res = run_bfb(os.path.join(_DATA, "c1_concat.lh"), solver=solver)
        p = res.path_strings[0]
        record(
            "concat_c1",
            p == "1+2+||5+6+|6-5-||2-|2+||5+6+||3+",
            time.perf_counter() - t0,
            p,
        )

        # 8. the reference README's four published TRX goldens, byte-
        # for-byte (/root/reference/README.md:132-167; inputs
        # reconstructed in tests/data/readme_{i1,i2,c1,c2}.lh since the
        # reference's fixtures live in the external Ambigram_paper repo)
        import io as _io

        for name, fixture, want, field in README_TRX_GOLDENS:
            t0 = time.perf_counter()
            buf = _io.StringIO()
            res = run_bfb(os.path.join(_DATA, fixture), solver=solver, out=buf)
            if field == "path":
                got = res.path_strings[0]
            elif field == "merged":
                got = res.merged_path_string
            else:  # two-stage console output
                got = buf.getvalue()
            ok = (want in got) if field == "console" else (got == want)
            # record what actually came out (truncated for console mode)
            # — the expected string is a constant, the output is the
            # diagnostic
            record(
                "readme_" + name,
                ok,
                time.perf_counter() - t0,
                got if field != "console" else got[-600:],
            )
    finally:
        os.chdir(cwd)

    ok = all(c["ok"] for c in checks)
    return {
        "suite": "ambigram_tpu golden",
        "solver": solver,
        "ok": ok,
        "checks": checks,
        "total_seconds": round(sum(c["seconds"] for c in checks), 3),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--solver", default="exact", choices=["exact", "device", "auto", "native"])
    parser.add_argument(
        "--profile",
        action="store_true",
        help="Print the phase-timer/counter report (incl. measured "
        "candidates-scored/s when the device solver ran) to stderr",
    )
    args = parser.parse_args(argv)
    report = run_suite(solver=args.solver)
    print(json.dumps(report, indent=2))
    if args.profile:
        from ambigram_tpu.utils.profiling import GLOBAL

        print(GLOBAL.report(), file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
