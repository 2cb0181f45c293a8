"""Command-line interface.

Mirrors the reference binary's options (localhap.cpp:22-40):

    python -m ambigram_tpu.cli --op bfb --in_lh test.lh --lp_prefix test
    python -m ambigram_tpu.cli --op sc_bfb --in_lh a.lh,b.lh --lp_prefix t

Options: --op {bfb, sc_bfb}, --in_lh, --lp_prefix, --juncdb,
--junc_info, --reversed, --all, plus engine extras (--solver,
--no-ledgers).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ambigram_tpu", description="JAX local haplotype constructor"
    )
    p.add_argument(
        "--op",
        required=True,
        choices=["bfb", "sc_bfb", "check", "solve"],
        help="Operate: bfb / sc_bfb (BFB engine); check / solve "
        "(legacy balancer + traversal pipeline, reference "
        "localhap.cpp:24-30)",
    )
    p.add_argument(
        "--in_lh",
        required=True,
        help="Input .lh file (comma list for sc_bfb), or a case MANIFEST "
        "(see --manifest) driving the batched device pipeline over many "
        "cases at once",
    )
    p.add_argument(
        "--manifest",
        action="store_true",
        help="Treat --in_lh as a case manifest: one case per line, "
        "whitespace-separated columns. Bulk line: <lh> [juncs=<path>]. "
        "Single-cell line: sc:<a.lh,b.lh,...> [edges=<parent:child,...>]. "
        "Blank lines and # comments are skipped; relative paths resolve "
        "against the manifest's directory. All bulk cases are solved in "
        "ONE device-sharded batch (run_bfb_many) and all sc samples in "
        "another (run_sc_bfb_many) — in place of looping the reference "
        "binary per sample (localhap.cpp:111-265). "
        "Files named *.manifest are detected automatically.",
    )
    p.add_argument(
        "--result_store",
        default="",
        help="Directory of per-case result checkpoints (manifest mode): "
        "completed cases are skipped on rerun, keyed by input content hash",
    )
    p.add_argument("--lp_prefix", default="sample", help="ILP output file prefix")
    p.add_argument(
        "--juncdb",
        default="",
        help="Input .juncs file with linkage information from linked/long reads",
    )
    p.add_argument(
        "--junc_info",
        default="false",
        help="Whether to use linked/long reads information in ILP (true/false)",
    )
    p.add_argument(
        "--reversed",
        dest="is_reversed",
        default="false",
        help="Find BFB paths starting from the negative strand (true/false)",
    )
    p.add_argument(
        "--all",
        dest="print_all",
        default="false",
        help="Print all possible BFB paths (true/false)",
    )
    p.add_argument(
        "--edges",
        default="",
        help="Sub-clone evolution edges for sc_bfb, e.g. a.lh:b.lh,a.lh:c.lh "
        "or 1:2,1:3 (reference grammar, localhap.cpp:417-430; default: "
        "all-pairs)",
    )
    p.add_argument(
        "--solver",
        default="auto",
        choices=["exact", "device", "auto", "native"],
        help="ILP solver backend (default: auto — in-process exact MILP "
        "for small programs, batched device search + LNS for large)",
    )
    p.add_argument(
        "--no-ledgers",
        action="store_true",
        help="Skip appending simulation_sv.txt / time.csv",
    )
    p.add_argument(
        "--emit_lp",
        action="store_true",
        help="Write <lp_prefix>.lp and <lp_prefix>.mps for each solved "
        "fitting program (the reference's debug/interchange artifact, "
        "LGM.cpp:4749-4750; opt-in here since no external solver runs)",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="Print the phase-timer/counter report after the run",
    )
    # legacy check/solve options (reference localhap.cpp:24-30)
    p.add_argument("--out_lh", default="", help="Balanced LH output (op check)")
    p.add_argument(
        "--hap",
        default="",
        help="Haplotype out file (op solve); defaults to "
        "<lp_prefix>.haploids.txt",
    )
    p.add_argument("--traversed", default="", help="Traversed path out file (op solve)")
    p.add_argument("--circuits", default="", help="Circuits out file (op solve)")
    p.add_argument("--hic_matrix", default="", help="Segment Hi-C matrix file (op solve)")
    p.add_argument("--tgs_order", default="", help="Long-fragment local order file (op solve)")
    return p


def _boolish(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    finally:
        if getattr(args, "profile", False):
            from ambigram_tpu.utils.profiling import GLOBAL

            print(GLOBAL.report(), file=sys.stderr)


def parse_manifest(path: str):
    """Parse a case manifest into (bulk, sc) work lists.

    bulk: [{"lh": ..., "juncs": ...}]; sc: [{"lh_paths": ..., "edges": ...}].
    Grammar per --manifest's help text. Raises ValueError with the line
    number on malformed lines — a silently skipped case is a missing
    result a user would misread as "no BFB found"."""
    import os

    base = os.path.dirname(os.path.abspath(path))

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(base, p)

    bulk, sc = [], []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            head, opts = cols[0], cols[1:]
            kv = {}
            for o in opts:
                if "=" not in o:
                    raise ValueError(
                        "%s:%d: expected key=value column, got %r"
                        % (path, lineno, o)
                    )
                k, v = o.split("=", 1)
                kv[k] = v
            if head.startswith("sc:"):
                clones = ",".join(
                    resolve(c) for c in head[3:].split(",") if c
                )
                if not clones:
                    raise ValueError(
                        "%s:%d: sc: line names no clone files" % (path, lineno)
                    )
                unknown = set(kv) - {"edges"}
                if unknown:
                    raise ValueError(
                        "%s:%d: unknown sc options %s" % (path, lineno, sorted(unknown))
                    )
                sc.append({"lh_paths": clones, "edges": kv.get("edges", "")})
            else:
                unknown = set(kv) - {"juncs"}
                if unknown:
                    raise ValueError(
                        "%s:%d: unknown options %s" % (path, lineno, sorted(unknown))
                    )
                bulk.append(
                    {
                        "lh": resolve(head),
                        "juncs": resolve(kv["juncs"]) if kv.get("juncs") else "",
                    }
                )
    return bulk, sc


def _run_manifest(args) -> int:
    from ambigram_tpu.engine.pipeline import run_bfb_many
    from ambigram_tpu.engine.sc import run_sc_bfb_many

    bulk, sc = parse_manifest(args.in_lh)
    if not bulk and not sc:
        print("error: manifest %s lists no cases" % args.in_lh, file=sys.stderr)
        return 2
    store = args.result_store or None
    ledger_dir = None if args.no_ledgers else "."
    n_done = 0
    if bulk:
        results = run_bfb_many(
            [c["lh"] for c in bulk],
            juncs_paths=[c["juncs"] for c in bulk],
            juncs_info=_boolish(args.junc_info),
            is_reversed=_boolish(args.is_reversed),
            solver=args.solver,
            out=sys.stdout,
            result_store=store,
            ledger_dir=ledger_dir,
        )
        for c, r in zip(bulk, results):
            n_done += 1
            print(
                "## %s: %d path(s), ilp_error %.4f%s"
                % (
                    c["lh"],
                    sum(1 for s in r.path_strings if s),
                    r.ilp_error,
                    "" if r.is_resolved else " [unresolved]",
                ),
                file=sys.stderr,
            )
    if sc:
        results = run_sc_bfb_many(
            sc,
            juncs_info=_boolish(args.junc_info),
            is_reversed=_boolish(args.is_reversed),
            solver=args.solver,
            out=sys.stdout,
            result_store=store,
            ledger_dir=ledger_dir,
        )
        for s, r in zip(sc, results):
            n_done += 1
            print(
                "## sc:%s: %d clone path list(s)"
                % (s["lh_paths"], len(r.path_strings)),
                file=sys.stderr,
            )
    print("## manifest complete: %d case(s)" % n_done, file=sys.stderr)
    return 0


def _dispatch(args) -> int:
    if args.manifest or args.in_lh.endswith(".manifest"):
        if args.op != "bfb":
            print(
                "error: --manifest batches both bulk and sc cases; use "
                "--op bfb (got --op %s)" % args.op,
                file=sys.stderr,
            )
            return 2
        # flags that would silently do nothing in manifest mode are an
        # input error (same rule as the --edges guard below): juncs and
        # edges belong in the manifest's per-case columns
        ignored = [
            name
            for name, val in (
                ("--juncdb", args.juncdb),
                ("--edges", args.edges),
                ("--all", _boolish(args.print_all)),
                ("--emit_lp", args.emit_lp),
            )
            if val
        ]
        if ignored:
            print(
                "error: %s not supported in manifest mode — put juncs=/"
                "edges= columns on the manifest lines instead"
                % ", ".join(ignored),
                file=sys.stderr,
            )
            return 2
        return _run_manifest(args)
    if args.edges and args.op != "sc_bfb":
        # --edges silently doing nothing would let a user believe an
        # evolution DAG was applied when it was not
        print(
            "error: --edges is only meaningful with --op sc_bfb (got --op %s)"
            % args.op,
            file=sys.stderr,
        )
        return 2
    if args.op == "bfb":
        from ambigram_tpu.engine.pipeline import run_bfb

        run_bfb(
            args.in_lh,
            juncs_path=args.juncdb,
            juncs_info=_boolish(args.junc_info),
            is_reversed=_boolish(args.is_reversed),
            print_all=_boolish(args.print_all),
            solver=args.solver,
            out=sys.stdout,
            ledger_dir=None if args.no_ledgers else ".",
            lp_prefix=args.lp_prefix,
            emit_lp=args.emit_lp,
        )
        return 0
    elif args.op == "check":
        from ambigram_tpu.legacy.balancer import apply_balance, balance, write_balanced_lh
        from ambigram_tpu.legacy.juncdb import JunctionDB
        from ambigram_tpu.legacy.reachability import (
            add_all_juncs_from_db,
            check_reachability,
        )
        from ambigram_tpu.model.genome import Genome

        g = Genome.from_lh(args.in_lh)
        g.calculate_hap_depth()
        g.calculate_copy_num()
        if args.juncdb:
            db = JunctionDB(args.juncdb)
            add_all_juncs_from_db(g, db)
        unreachable = check_reachability(g)
        for kind, vs in unreachable.items():
            for v in vs:
                print("unreachable (%s): %s" % (kind, v.info()))
        from ambigram_tpu.exceptions import ILPBalancerInfeasibleError

        try:
            res = balance(g)
        except ILPBalancerInfeasibleError:
            # no circulation keeps every observed junction active (the
            # reference's cbc would report Infeasible here and the run
            # would die at parseILP); retry letting junctions switch
            # off at the maximum penalty
            print("balancer infeasible with all junctions on; relaxing")
            res = balance(g, allow_junction_off=True)
        apply_balance(g, res)
        out_lh = args.out_lh or (args.lp_prefix + ".balanced.lh")
        write_balanced_lh(g, out_lh, original_lh=args.in_lh)
        print("balanced graph written to %s (objective %.4f)" % (out_lh, res.objective))
        return 0
    elif args.op == "solve":
        from ambigram_tpu.legacy.juncdb import JunctionDB
        from ambigram_tpu.legacy.reachability import connect_source_sink
        from ambigram_tpu.legacy.traversal import Traverser
        from ambigram_tpu.model.genome import Genome

        g = Genome.from_lh(args.in_lh)
        g.calculate_hap_depth()
        g.calculate_copy_num()
        connect_source_sink(g)
        for j in g.junctions:
            if j.weight.copy_num < 0:
                j.weight.set_copy_num(
                    max(round(j.weight.coverage / max(g.haploid_depth, 1e-9)), 1)
                )
        db = JunctionDB(args.juncdb) if args.juncdb else JunctionDB(g.junctions)
        tr = Traverser(g)
        if args.hic_matrix:
            tr.read_hic_matrix(args.hic_matrix)
        if args.tgs_order:
            tr.read_long_frags(args.tgs_order)
        tr.traverse_graph(db)
        tr.extract_circuits()
        tr.divide_circuits()
        tr.generate_haploids()
        if args.circuits:
            tr.write_circuits(args.circuits)
        if args.traversed:
            tr.write_traversed_paths(args.traversed)
        hap = args.hap or (args.lp_prefix + ".haploids.txt")
        tr.write_haploids(hap)
        print("haploids written to %s" % hap)
        return 0
    else:
        from ambigram_tpu.engine.sc import run_sc_bfb

        run_sc_bfb(
            args.in_lh,
            juncs_path=args.juncdb,
            juncs_info=_boolish(args.junc_info),
            is_reversed=_boolish(args.is_reversed),
            print_all=_boolish(args.print_all),
            solver=args.solver,
            out=sys.stdout,
            ledger_dir=None if args.no_ledgers else ".",
            lp_prefix=args.lp_prefix,
            edges=args.edges,
            emit_lp=args.emit_lp,
        )
        return 0


if __name__ == "__main__":
    sys.exit(main())
