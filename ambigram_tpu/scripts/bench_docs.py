"""Regenerate the benchmark blocks in README.md / docs/ARCHITECTURE.md
from a measured bench artifact, so published numbers can never drift
from measurements.

Usage:
    python bench.py > bench_out.txt 2>&1       # run on the GPU
    python -m ambigram_tpu.scripts.bench_docs bench_out.txt

or from a driver artifact (a JSON object whose "tail" holds the output):
    python -m ambigram_tpu.scripts.bench_docs artifact.json

The input is scanned for the engine's JSON metric lines (one per
metric). The blocks between `<!-- BENCH:BEGIN -->` / `<!-- BENCH:END -->`
markers are replaced wholesale; nothing outside the markers is touched.
The snapshot used is archived to docs/bench_snapshot.json so the docs
are reproducible from the repo alone.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BEGIN = "<!-- BENCH:BEGIN (generated by ambigram_tpu.scripts.bench_docs — do not edit by hand) -->"
END = "<!-- BENCH:END -->"


def extract_metrics(text: str) -> Dict[str, dict]:
    """All engine metric JSON objects found in the text, keyed by their
    "metric" field. Accepts raw bench output, or a driver artifact
    (whose "tail" holds the stdout lines)."""
    metrics: Dict[str, dict] = {}
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            if "metric" in doc:
                metrics[doc["metric"]] = doc
            if isinstance(doc.get("parsed"), dict) and "metric" in doc["parsed"]:
                metrics[doc["parsed"]["metric"]] = doc["parsed"]
            tail = doc.get("tail")
            text = tail if isinstance(tail, str) else ""
    except ValueError:
        pass
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj:
            metrics[obj["metric"]] = obj
    return metrics


def _fmt_stage_table(stages: dict) -> str:
    rows = ["| stage | seconds |", "|---|---|"]
    for name, secs in sorted(stages.items(), key=lambda kv: -kv[1]):
        rows.append("| `%s` | %.1f |" % (name, secs))
    return "\n".join(rows)


def device_name(m: Dict[str, dict]) -> str:
    """The card the artifact was measured on, with its power limit, as
    the primary line's `device` block names it."""
    dev = (m.get("bfb_candidates_scored_per_sec_per_chip") or {}).get("device") or {}
    smi = dev.get("nvidia_smi") or ""
    if "," in smi:
        name, limit = smi.split(";")[0].rsplit(",", 1)
        return "%d x %s, power limit %s" % (dev.get("count", 1), name, limit.strip())
    return "%s (%s)" % (dev.get("kind", "unknown device"), dev.get("platform", "?"))


def render_readme_block(m: Dict[str, dict]) -> str:
    out: List[str] = [BEGIN, ""]
    prim = m.get("bfb_candidates_scored_per_sec_per_chip")
    where = device_name(m)
    if prim:
        out += [
            "Measured on %s (kernel path `%s`):" % (where, prim.get("kernel_path", "?")),
            "",
            "```json",
            json.dumps(prim, indent=1),
            "```",
            "",
            "Timing is async-dispatch-proof: iterations are chained through a",
            "data dependence inside one jitted XLA loop and the clock stops",
            "after a host fetch; the reported rate is the best of 3 runs of the",
            "identical deterministic workload. The `matmul` block is the",
            "arithmetic: one candidate score is a `[1, vars] x [vars, rows]`",
            "matmul, 2 x vars x rows operations.",
            "",
        ]
    suite = m.get("suite_seconds_large_cases")
    if suite:
        # case count from the explicit field, else the "4xS48" prefix
        n_cases = suite.get("n_cases")
        if n_cases is None:
            match = re.match(r"(\d+)x", str(suite.get("cases", "")))
            n_cases = int(match.group(1)) if match else 0
        out += [
            "End-to-end **time-to-solution** on a suite of large noisy cases",
            "(%s — the regime the auto solver routes to the device search)," % suite.get("cases", "?"),
            "%s vs the host HiGHS MILP at a 30 s/case budget" % where,
            "(one-time bucket compile: %.0f s, excluded from every mode):" % suite.get("device_compile_seconds", 0),
            "",
            "| mode | suite seconds | quality (sum eps) | solved |",
            "|---|---|---|---|",
        ]
        for mode in ("auto", "device", "exact"):
            leg = suite.get(mode)
            if leg:
                out.append(
                    "| %s | %.1f | %.2f | %d/%s |"
                    % (mode, leg["seconds"], leg["eps_sum"], leg["solved"], n_cases or "?")
                )
        auto = suite.get("auto", {})
        if auto.get("stages"):
            out += [
                "",
                "Per-stage breakdown of the auto run (host LNS polish and LP",
                "bounds dominate; the device search itself is the `score` line):",
                "",
                _fmt_stage_table(auto["stages"]),
            ]
        out.append("")
    batch = m.get("batch_throughput_cases_per_min")
    if batch:
        bd, se = batch.get("batch_device", {}), batch.get("serial_exact", {})
        out += [
            "Batch throughput (`run_bfb_many`, %s, one identical warm-up" % batch.get("cases", "?"),
            "run outside the clock — steady-state wave throughput, every",
            "stage program pre-compiled) vs the reference-shaped serial per-case loop",
            "(in-process exact MILP at 15 s/case standing in for check+cbc):",
            "",
            "| pipeline | seconds | cases/min | solved | quality (sum eps, lower wins) |",
            "|---|---|---|---|---|",
            "| `run_bfb_many` (device) | %.1f | %.2f | %d | %s |"
            % (
                bd.get("seconds", 0),
                bd.get("cases_per_min", 0),
                bd.get("solved", 0),
                bd.get("eps_sum", "—"),
            ),
            "| serial exact loop | %.1f | %.2f | %d | %s |"
            % (
                se.get("seconds", 0),
                se.get("cases_per_min", 0),
                se.get("solved", 0),
                se.get("eps_sum", "—"),
            ),
            "",
            "**Batch speedup: %.2fx** (at better solution quality)."
            % batch.get("batch_speedup", 0),
            "",
        ]
    big = m.get("large_s_device_vs_exact")
    if big:
        out += [
            "Large-S legs (opt-in: `AMBIGRAM_BENCH_SUITE=big python bench.py`):",
            "",
            "| case | vars | device (s / eps) | exact 60s (s / eps) |",
            "|---|---|---|---|",
        ]
        for name in sorted(k for k in big if k.startswith("S")):
            leg = big[name]
            out.append(
                "| %s | %d | %.1f / %s | %.1f / %s |"
                % (
                    name,
                    leg.get("vars", 0),
                    leg["device"]["seconds"],
                    leg["device"]["eps"],
                    leg["exact_60s"]["seconds"],
                    leg["exact_60s"]["eps"],
                )
            )
        out.append("")
    out.append(END)
    return "\n".join(out)


def render_architecture_block(m: Dict[str, dict]) -> str:
    suite = m.get("suite_seconds_large_cases", {})
    lines = [BEGIN, ""]
    # all three legs must be present with real times: rendering a ratio
    # against a missing leg would publish a corrupted number, which is
    # exactly the drift this generator exists to prevent
    legs = {k: suite.get(k, {}) for k in ("auto", "device", "exact")}

    def _has_time(leg: dict) -> bool:
        # explicit type-and-sign check: a legitimate 0.0-second leg is
        # still unusable as a ratio denominator, but absent/null must
        # not be silently conflated with it — report which leg is bad
        s = leg.get("seconds")
        return isinstance(s, (int, float)) and s > 0

    missing = [k for k in legs if not _has_time(legs[k])]
    if suite and missing:
        print(
            "bench_docs: architecture block skipped — leg(s) %s have no "
            "positive 'seconds' in the artifact" % ",".join(missing)
        )
    if suite and not missing:
        dev_s = legs["device"]["seconds"]
        auto_s = legs["auto"]["seconds"]
        ex_s = legs["exact"]["seconds"]
        same_quality = legs["device"].get("eps_sum") == legs["exact"].get("eps_sum")
        # describe auto-vs-device honestly from the numbers (run-to-run
        # variance means either may come out ahead on a given run)
        diff_pct = 100.0 * (auto_s - dev_s) / dev_s
        if abs(diff_pct) < 3.0:
            auto_note = "auto matches pure device within noise"
        elif diff_pct < 0:
            auto_note = "auto measured %.0f%% faster than pure device" % -diff_pct
        else:
            auto_note = "auto measured %.0f%% slower than pure device" % diff_pct
        lines += [
            "Measured on the large-case suite (%s, %s):"
            % (suite.get("cases", "?"), device_name(m)),
            "auto %.1f s / device %.1f s / exact (30 s/case HiGHS) %.1f s"
            % (auto_s, dev_s, ex_s),
            "at total epsilon %s / %s / %s — the device path %s host-exact"
            % (
                legs["auto"].get("eps_sum", "?"),
                legs["device"].get("eps_sum", "?"),
                legs["exact"].get("eps_sum", "?"),
                "matches" if same_quality else "trades",
            ),
            "quality at %.1fx the speed, and %s" % (ex_s / dev_s, auto_note),
            "(stage breakdown in the README benchmark block).",
            "",
        ]
    lines.append(END)
    return "\n".join(lines)


def replace_block(path: str, new_block: str) -> bool:
    with open(path) as f:
        text = f.read()
    pattern = re.compile(re.escape(BEGIN) + r".*?" + re.escape(END), re.S)
    if not pattern.search(text):
        return False
    with open(path, "w") as f:
        f.write(pattern.sub(lambda _m: new_block, text))
    return True


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        text = f.read()
    metrics = extract_metrics(text)
    if not metrics:
        print("no metric lines found in %s" % argv[0], file=sys.stderr)
        return 1
    snap = os.path.join(_REPO, "docs", "bench_snapshot.json")
    with open(snap, "w") as f:
        json.dump(metrics, f, indent=1, sort_keys=True)
    ok1 = replace_block(os.path.join(_REPO, "README.md"), render_readme_block(metrics))
    ok2 = replace_block(
        os.path.join(_REPO, "docs", "ARCHITECTURE.md"), render_architecture_block(metrics)
    )
    print(
        "snapshot -> %s; README block %s; ARCHITECTURE block %s"
        % (snap, "updated" if ok1 else "MARKERS MISSING", "updated" if ok2 else "MARKERS MISSING")
    )
    return 0 if (ok1 and ok2) else 1


if __name__ == "__main__":
    sys.exit(main())
