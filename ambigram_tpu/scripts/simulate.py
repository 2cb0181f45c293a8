"""BFB case simulation.

Two layers:

1. `simulate_bfb_case` — a pure-Python generator that *plays the BFB
   process itself* (break - fusion - bridge rounds on a chromosome
   arm) and emits the ground-truth haplotype plus every derived input
   file (SV table, SEG table, LH, JUNCS). This replaces the reference's
   aligner-dependent simulation chain for testing and benchmarking
   (reference equivalents: script/bfb_scripts.py simulate_* and
   script/simu.py, which need wgsim/bwa/pbsim/LRSIM to run).

2. `simulate_*_commands` — the external-tool recipes from
   bfb_scripts.py:51-208 (PE via wgsim+bwa+svaba, PB via pbsim3+ngmlr+
   sniffles, ONT, 10x via LRSIM), emitted as argv lists and gated on
   tool availability, for users with the aligners installed.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Step = Tuple[int, str]  # (segment id, '+'/'-')


@dataclass
class BfbCase:
    n_segments: int
    truth_path: List[Step]
    seg_cn: np.ndarray  # [n] per-segment multiplicity in the truth path
    fbi: Dict[int, int]  # fold anchor segment -> count
    coverage: float
    lh_text: str
    sv_text: str
    seg_text: str
    juncs_lines: List[str] = field(default_factory=list)

    @property
    def truth_string(self) -> str:
        out = []
        for k, (seg, d) in enumerate(self.truth_path):
            out.append("%d%s" % (seg, d))
            if k + 1 < len(self.truth_path) and self.truth_path[k + 1][1] != d:
                out.append("|")
        return "".join(out)


def bfb_process(
    rng: np.random.Generator, n_segments: int, rounds: int
) -> List[Step]:
    """Run `rounds` break-fusion-bridge cycles on the arm 1..n.

    The path starts as 1..n (toward the telomere). Each round breaks
    the current path at a uniformly random position, keeps the
    centromeric prefix, and fuses on its reverse complement (the
    bridge). The final path is re-capped with the distal arm segment
    run so it terminates at a telomere."""
    path: List[Step] = [(i, "+") for i in range(1, n_segments + 1)]
    for _ in range(rounds):
        # break after position b (1 <= b < len), keep prefix
        b = int(rng.integers(1, len(path)))
        prefix = path[:b]
        mirrored = [(seg, "-" if d == "+" else "+") for seg, d in reversed(prefix)]
        path = prefix + mirrored
        # the mirrored half ends at the centromere side; re-extend
        # toward the telomere so the next break has material
        last_seg, last_dir = path[-1]
        if last_dir == "-" and last_seg == 1:
            # reached the centromere: continue on the other strand
            path = path + [(i, "+") for i in range(1, n_segments + 1)]
    # final cap: if the path ends mid-arm on '+', run out to n
    last_seg, last_dir = path[-1]
    if last_dir == "+" and last_seg < n_segments:
        path = path + [(i, "+") for i in range(last_seg + 1, n_segments + 1)]
    elif last_dir == "-" and last_seg > 1:
        path = path + [(i, "-") for i in range(last_seg - 1, 0, -1)]
    return path


def random_nested_chain(
    rng: np.random.Generator, n_segments: int, max_depth: int = 5
) -> List[Tuple[int, int]]:
    """A strictly nested loop chain (each child shares one endpoint
    with its parent and is strictly shorter), the structure family the
    reference's ILP hierarchy constraints represent exactly — cf. the
    EGFR example's chain l(1,6) > l(2,6) > l(2,4) > l(3,4)."""
    a, b = 1, n_segments
    chain = [(a, b)]
    last_side = None
    for _ in range(max_depth - 1):
        if b - a < 1:
            break
        # strictly alternate which endpoint shrinks: two consecutive
        # same-side shrinks make both results children of the same
        # ancestor and break the model's l + sum(children) <= 2 cap
        if last_side is None:
            side = "right" if rng.random() < 0.5 else "left"
        else:
            side = "left" if last_side == "right" else "right"
        if side == "right":
            b = int(rng.integers(a, b))
        else:
            a = int(rng.integers(a + 1, b + 1))
        last_side = side
        chain.append((a, b))
        if rng.random() < 0.25:
            break
    return chain


def chain_to_path(chain: List[Tuple[int, int]]) -> List[Step]:
    """Replay a nested loop chain through the engine's own DAG + splice
    machinery to get the canonical truth path."""
    from ambigram_tpu.engine.dag import all_topological_orders, construct_dag
    from ambigram_tpu.engine.enumerate import (
        enumerate_pairs,
        pair_index,
        sorted_key_order,
    )
    from ambigram_tpu.engine.path import get_bfb
    from ambigram_tpu.model.genome import Genome

    start = min(a for a, _ in chain)
    end = max(b for _, b in chain)
    n = max(b for _, b in chain)
    g = Genome()
    for i in range(1, n + 1):
        g.add_segment(i, 0, "sim", i * 1000, i * 1000 + 999, 30.0, 1.0, 1.0)
    pairs = enumerate_pairs(start, end)
    T = len(pairs)
    element_cn = np.zeros(2 * T, dtype=np.int64)
    for a, b in chain:
        element_cn[T + pair_index(start, end, a, b)] += 1
    entries = sorted_key_order(pairs)
    adj, node2pat, node2loop = construct_dag(entries, element_cn)
    orders = [o for o in all_topological_orders(adj) if o]
    path = get_bfb(g, orders, node2pat, node2loop, {}, False, False)
    return [(v.id, v.dir) for v in path]


def path_stats(path: List[Step], n_segments: int) -> Tuple[np.ndarray, Dict[int, int]]:
    seg_cn = np.zeros(n_segments, dtype=np.int64)
    fbi: Dict[int, int] = {}
    for seg, _d in path:
        seg_cn[seg - 1] += 1
    for k in range(len(path) - 1):
        (s1, d1), (s2, d2) = path[k], path[k + 1]
        if d1 != d2:
            anchor = s1
            fbi[anchor] = fbi.get(anchor, 0) + 1
    return seg_cn, fbi


def sample_juncs_fragments(
    rng: np.random.Generator, path: List[Step], n_fragments: int, min_len: int = 3, max_len: int = 7
) -> List[str]:
    """Long-read style evidence: random subpaths of the truth path,
    formatted as JUNCS lines ("6+ 6- 5- ...")."""
    lines = []
    for _ in range(n_fragments):
        if len(path) <= min_len:
            break
        length = int(rng.integers(min_len, min(max_len, len(path)) + 1))
        start = int(rng.integers(0, len(path) - length + 1))
        frag = path[start : start + length]
        lines.append(" ".join("%d%s" % (s, d) for s, d in frag))
    return lines


def simulate_bfb_case(
    seed: int = 0,
    n_segments: int = 8,
    rounds: int = 3,
    coverage: float = 30.0,
    chrom: str = "chr7",
    seg_len: int = 1000,
    start_pos: int = 1000,
    noise: float = 0.0,
    n_juncs_fragments: int = 0,
    mode: str = "nested",
) -> BfbCase:
    """mode="nested": reference-representable nested loop chains
    (exactly recoverable). mode="process": raw break-fusion-bridge
    rounds, which can exceed the reference model's nesting caps."""
    rng = np.random.default_rng(seed)
    if mode == "nested":
        chain = random_nested_chain(rng, n_segments)
        path = chain_to_path(chain)
    else:
        path = bfb_process(rng, n_segments, rounds)
    return case_from_path(
        path,
        n_segments,
        rng,
        seed=seed,
        coverage=coverage,
        chrom=chrom,
        seg_len=seg_len,
        start_pos=start_pos,
        noise=noise,
        n_juncs_fragments=n_juncs_fragments,
    )


def random_bfb_program(rng: np.random.Generator, n: int):
    """A random but structurally consistent fitting program on segments
    1..n: a CN profile stacked from 2-4 random loops plus 0/1 noise per
    segment. Small enough for the exact MILP, so device solvers can be
    checked against it."""
    from ambigram_tpu.engine.enumerate import enumerate_pairs
    from ambigram_tpu.engine.ilp import build_bfb_program

    T = n * (n + 1) // 2
    pairs = enumerate_pairs(1, n)
    x = np.zeros(2 * T)
    for _ in range(rng.integers(2, 5)):
        t = rng.integers(0, T)
        x[T + t] += rng.integers(1, 3)
    seg_cn = np.zeros(n)
    fbi_cn = np.zeros(n)
    for t in range(T):
        i, j = pairs[t]
        if x[T + t] > 0:
            seg_cn[i - 1 : j] += 2 * x[T + t]
            fbi_cn[i - 1] += x[T + t]
            fbi_cn[j - 1] += x[T + t]
    seg_cn += rng.integers(0, 2, size=n)
    return build_bfb_program(1, n, seg_cn, fbi_cn, seg_cn.sum(), 1)


def case_from_path(
    path: List[Step],
    n_segments: int,
    rng: np.random.Generator,
    seed: int = 0,
    coverage: float = 30.0,
    chrom: str = "chr7",
    seg_len: int = 1000,
    start_pos: int = 1000,
    noise: float = 0.0,
    n_juncs_fragments: int = 0,
    sample_name: Optional[str] = None,
) -> BfbCase:
    """Assemble every derived input file (SV/SEG/LH/JUNCS) for a known
    truth path — the common back half of simulate_bfb_case, shared with
    the single-cell simulator."""
    seg_cn, fbi = path_stats(path, n_segments)

    # SEG table
    seg_lines = []
    for i in range(n_segments):
        s = start_pos + i * seg_len
        e = s + seg_len - 1
        depth = seg_cn[i] * coverage / 2.0
        if noise:
            depth = max(0.0, depth * (1.0 + rng.normal(0, noise)))
        seg_lines.append("%s:%d-%d\t%g" % (chrom, s, e, depth))
    seg_text = "\n".join(seg_lines) + "\n"

    # SV table: fold-back inversions at their genomic breakpoints
    sv_lines = [
        "chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn"
    ]
    junc_records = []
    for k in range(len(path) - 1):
        (s1, d1), (s2, d2) = path[k], path[k + 1]
        if d1 == d2:
            continue
        junc_records.append((s1, d1, s2, d2))
    # aggregate identical junctions
    agg: Dict[Tuple, int] = {}
    for rec in junc_records:
        agg[rec] = agg.get(rec, 0) + 1
    for (s1, d1, s2, d2), cn in agg.items():
        seg_s = start_pos + (s1 - 1) * seg_len
        seg_e = seg_s + seg_len - 1
        pos1 = seg_e if d1 == "+" else seg_s
        seg_s2 = start_pos + (s2 - 1) * seg_len
        seg_e2 = seg_s2 + seg_len - 1
        pos2 = seg_s2 if d2 == "+" else seg_e2
        sv_lines.append(
            "%s\t%d\t%s\t%s\t%d\t%s\t%d" % (chrom, pos1, d1, chrom, pos2, d2, cn)
        )
    sv_text = "\n".join(sv_lines) + "\n"

    # LH text (direct, like generate_lh would produce)
    lh = [
        "SAMPLE_NAME %s" % (sample_name or "sim%d" % seed),
        "AVG_CHR_SEG_DP %g" % coverage,
        "AVG_WHOLE_HOST_DP %g" % coverage,
        "AVG_JUNC_DP %g" % coverage,
        "PURITY 1",
        "AVG_TUMOR_PLOIDY 2",
        "PLOIDY 2m1",
        "VIRUS_START %d" % (n_segments + 1),
        "SOURCE 1",
        "SINK %d" % n_segments,
    ]
    for i in range(n_segments):
        s = start_pos + i * seg_len
        e = s + seg_len - 1
        depth = seg_cn[i] * coverage / 2.0
        cn: float = float(seg_cn[i])
        if noise:
            depth = max(0.0, depth * (1.0 + rng.normal(0, noise)))
            cn = -1.0  # let the engine derive CN from depth
        lh.append("SEG H:%d:%s:%d:%d %g %g" % (i + 1, chrom, s, e, depth, cn))
    for (s1, d1, s2, d2), cn in agg.items():
        lh.append(
            "JUNC H:%d:%s H:%d:%s %g %g U B"
            % (s1, d1, s2, d2, cn * coverage / 2.0, float(cn))
        )
    lh_text = "\n".join(lh) + "\n"

    juncs_lines = sample_juncs_fragments(rng, path, n_juncs_fragments)
    return BfbCase(
        n_segments=n_segments,
        truth_path=path,
        seg_cn=seg_cn,
        fbi=fbi,
        coverage=coverage,
        lh_text=lh_text,
        sv_text=sv_text,
        seg_text=seg_text,
        juncs_lines=juncs_lines,
    )


def mutate_nested_chain(
    rng: np.random.Generator,
    chain: List[Tuple[int, int]],
    n_segments: int,
    max_extra: int = 3,
) -> List[Tuple[int, int]]:
    """A child clone's chain: keep a random prefix of the parent's
    nested chain (shared evolutionary history), then regrow with fresh
    alternating-side shrinks (private BFB rounds after divergence).
    Preserves the validity invariants of random_nested_chain."""
    keep = int(rng.integers(1, len(chain) + 1))
    out = list(chain[:keep])
    # recover which endpoint the last kept step shrank, for alternation
    last_side = None
    if keep >= 2:
        last_side = "right" if out[-1][1] < out[-2][1] else "left"
    a, b = out[-1]
    for _ in range(int(rng.integers(0, max_extra + 1))):
        if b - a < 1:
            break
        if last_side is None:
            side = "right" if rng.random() < 0.5 else "left"
        else:
            side = "left" if last_side == "right" else "right"
        if side == "right":
            b = int(rng.integers(a, b))
        else:
            a = int(rng.integers(a + 1, b + 1))
        last_side = side
        out.append((a, b))
    return out


@dataclass
class ScCase:
    """K subclones diverging along an evolution DAG, each with a known
    truth path — the fixture family for `run_sc_bfb` (the reference's
    BFB_ILP_SC has no simulator; clones there come from real data)."""

    cases: List[BfbCase]
    chains: List[List[Tuple[int, int]]]
    edges: List[Tuple[int, int]]  # (parent, child), 0-based clone ids

    def edges_arg(self, names: List[str]) -> str:
        """The CLI --edges string for these evolution edges."""
        return ",".join("%s:%s" % (names[a], names[b]) for a, b in self.edges)


def simulate_sc_case(
    seed: int = 0,
    n_clones: int = 3,
    n_segments: int = 12,
    coverage: float = 30.0,
    noise: float = 0.0,
    topology: str = "chain",
) -> ScCase:
    """Simulate an SC case: the root clone plays a nested BFB chain;
    each child keeps a shared prefix of its parent's chain and adds
    private rounds. topology="chain" (0->1->...) or "star" (0->k)."""
    rng = np.random.default_rng(seed)
    root = random_nested_chain(rng, n_segments)
    chains = [root]
    edges: List[Tuple[int, int]] = []
    for k in range(1, n_clones):
        parent = 0 if topology == "star" else k - 1
        chains.append(mutate_nested_chain(rng, chains[parent], n_segments))
        edges.append((parent, k))
    cases = []
    for k, chain in enumerate(chains):
        path = chain_to_path(chain)
        cases.append(
            case_from_path(
                path,
                n_segments,
                rng,
                seed=seed,
                coverage=coverage,
                noise=noise,
                sample_name="sc%d_clone%d" % (seed, k),
            )
        )
    return ScCase(cases=cases, chains=chains, edges=edges)


def all_junctions(path: List[Step]) -> Dict[Tuple[int, str, int, str], int]:
    """Every junction the path traverses (reference adjacencies
    included), canonicalized so a traversal and its reverse complement
    count toward the same junction — the accounting the legacy-dialect
    LH (JUNC rows for adjacencies too, cf.
    /root/reference/script/test.lh:83-194) needs."""
    flip = {"+": "-", "-": "+"}
    agg: Dict[Tuple[int, str, int, str], int] = {}
    for k in range(len(path) - 1):
        (s1, d1), (s2, d2) = path[k], path[k + 1]
        rep = (s1, d1, s2, d2)
        comp = (s2, flip[d2], s1, flip[d1])
        key = min(rep, comp)
        agg[key] = agg.get(key, 0) + 1
    return agg


def legacy_lh_text(case: BfbCase, noise: float = 0.0, seed: int = 0) -> str:
    """Emit the case in the LEGACY localHap dialect
    (SAMPLE/AVG_DP/SOURCE H:1/SEG H:<id> <depth>, depth-only rows;
    grammar of /root/reference/script/test.lh:1-8). Unlike the modern
    writer, every traversed junction — adjacency or SV — gets a JUNC
    row, because the legacy balancer/traversal stack needs the full
    flow graph."""
    rng = np.random.default_rng(seed)
    n = case.n_segments
    cov = case.coverage

    def jitter(x: float) -> float:
        return max(0.0, x * (1.0 + rng.normal(0, noise))) if noise else x

    lines = [
        "SAMPLE sim_legacy",
        "AVG_DP %g" % cov,
        "PURITY 1",
        "AVG_PLOIDY 2",
        "PLOIDY 2m1",
        "SOURCE H:1",
        "SINK H:%d" % n,
    ]
    for i in range(n):
        lines.append("SEG H:%d %g" % (i + 1, jitter(case.seg_cn[i] * cov / 2.0)))
    for (s1, d1, s2, d2), cn in sorted(all_junctions(case.truth_path).items()):
        lines.append(
            "JUNC H:%d:%s H:%d:%s %g" % (s1, d1, s2, d2, jitter(cn * cov / 2.0))
        )
    return "\n".join(lines) + "\n"


def juncdb_text(
    case: BfbCase,
    chrom: str = "chr7",
    seg_len: int = 1000,
    start_pos: int = 1000,
) -> str:
    """Emit the case's junctions as a JunctionDB TSV (the `junc.db`
    format, /root/reference/script/junc.db header + JunctionDB.cpp
    readDB columns)."""
    rows = ["chrom_5p\tpos_5p\tstrand_5p\tchrom_3p\tpos_3p\tstrand_3p\tcount"]
    for (s1, d1, s2, d2), cn in sorted(all_junctions(case.truth_path).items()):
        seg_s1 = start_pos + (s1 - 1) * seg_len
        pos1 = (seg_s1 + seg_len - 1) if d1 == "+" else seg_s1
        seg_s2 = start_pos + (s2 - 1) * seg_len
        pos2 = seg_s2 if d2 == "+" else (seg_s2 + seg_len - 1)
        rows.append(
            "%s\t%d\t%s\t%s\t%d\t%s\t%d" % (chrom, pos1, d1, chrom, pos2, d2, cn)
        )
    return "\n".join(rows) + "\n"


def simulate_virus_case(
    seed: int = 0,
    n_host: int = 6,
    n_virus: int = 2,
    coverage: float = 30.0,
    noise: float = 0.0,
    host_chrom: str = "chr8",
    seg_len: int = 1000,
    start_pos: int = 1000,
) -> BfbCase:
    """Virus-integration (PROP I1) simulation: a virus block integrates
    between two host segments, the merged arm undergoes a nested BFB
    chain, and the LH is emitted in ORIGINAL coordinates (host chromosome
    + separate virus chromosome, VIRUS_START/AVG_VIRUS_SEG_DP header,
    integration junctions, PROP I1) — the input family the reference
    generates via script/simu.py:278-316 and solves via insertBeforeBFB
    (LGM.cpp:4195-4293) + virusBFB (LGM.cpp:3839-3939).

    The returned truth_path is in original segment ids, so the solved
    path (which virus_bfb maps back to original ids) is directly
    comparable. Nested-chain endpoints are kept off the virus block so
    no fold-back junction anchors on a virus segment (insertBeforeBFB
    forces junctions touching insertion ids to +/+ orientation,
    LGM.cpp:4262-4266 — a fold there would be unrepresentable)."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, n_host))  # virus integrates between k, k+1
    n = n_host + n_virus
    virus_positions = set(range(k + 1, k + n_virus + 1))  # merged ids

    chain = None
    for _ in range(64):
        cand = random_nested_chain(rng, n)
        if all(
            a not in virus_positions and b not in virus_positions
            for a, b in cand
        ):
            chain = cand
            break
    if chain is None:
        chain = [(1, n)]  # endpoints 1/n are host by construction
    merged_path = chain_to_path(chain)
    merged_cn, fbi = path_stats(merged_path, n)

    def orig(m: int) -> int:
        if m <= k:
            return m
        if m <= k + n_virus:
            return n_host + (m - k)  # virus ids n_host+1 .. n_host+n_virus
        return m - n_virus

    truth_path = [(orig(m), d) for m, d in merged_path]
    seg_cn = np.zeros(n, dtype=np.int64)
    for m in range(1, n + 1):
        seg_cn[orig(m) - 1] = merged_cn[m - 1]

    def jitter(x: float) -> float:
        return max(0.0, x * (1.0 + rng.normal(0, noise))) if noise else x

    lh = [
        "SAMPLE_NAME virus_sim%d" % seed,
        "AVG_CHR_SEG_DP %g" % coverage,
        "AVG_WHOLE_HOST_DP %g" % coverage,
        "AVG_VIRUS_SEG_DP %g" % coverage,
        "AVG_JUNC_DP %g" % coverage,
        "PURITY 1",
        "AVG_TUMOR_PLOIDY 2",
        "PLOIDY 2m1",
        "VIRUS_START %d" % (n_host + 1),
        "SOURCE 1,%d" % (n_host + 1),
        "SINK %d,%d" % (n_host, n_host + n_virus),
    ]
    for i in range(1, n_host + 1):
        s = start_pos + (i - 1) * seg_len
        depth = jitter(seg_cn[i - 1] * coverage / 2.0)
        cn = -1.0 if noise else float(seg_cn[i - 1])
        lh.append(
            "SEG H:%d:%s:%d:%d %g %g" % (i, host_chrom, s, s + seg_len - 1, depth, cn)
        )
    for v in range(1, n_virus + 1):
        i = n_host + v
        s = 1 + (v - 1) * seg_len
        # virus-segment CN derives from whole-host depth x2
        # (src/Graph.cpp:369-405): depth = cn * coverage / 2 satisfies it
        depth = jitter(seg_cn[i - 1] * coverage / 2.0)
        cn = -1.0 if noise else float(seg_cn[i - 1])
        lh.append("SEG H:%d:virus:%d:%d %g %g" % (i, s, s + seg_len - 1, depth, cn))

    for (s1, d1, s2, d2), cn in sorted(all_junctions(truth_path).items()):
        if abs(s1 - s2) == 1 and d1 == d2:
            continue  # reference adjacency (cross-chrom pairs are never
            # numerically adjacent: k <= n_host - 1)
        if (d1, d2) == ("-", "-"):
            # emit the +/+ complement so integration junctions read
            # host+ -> virus+ / virus+ -> host+ like the reference's
            s1, d1, s2, d2 = s2, "+", s1, "+"
        lh.append(
            "JUNC H:%d:%s H:%d:%s %g %g U B"
            % (s1, d1, s2, d2, jitter(cn * coverage / 2.0), float(cn))
        )
    lh.append("PROP I1:%s:virus:%s M:%s" % (host_chrom, host_chrom, host_chrom))
    lh_text = "\n".join(lh) + "\n"

    truth = BfbCase(
        n_segments=n,
        truth_path=truth_path,
        seg_cn=seg_cn,
        fbi=fbi,
        coverage=coverage,
        lh_text=lh_text,
        sv_text="",
        seg_text="",
    )
    return truth


def write_case(case: BfbCase, prefix: str) -> Dict[str, str]:
    paths = {
        "lh": prefix + ".lh",
        "sv": prefix + "_sv.txt",
        "seg": prefix + "_seg.txt",
        "truth": prefix + "_truth.txt",
    }
    contents = {
        "lh": case.lh_text,
        "sv": case.sv_text,
        "seg": case.seg_text,
        "truth": case.truth_string + "\n",
    }
    if case.juncs_lines:
        paths["juncs"] = prefix + ".juncs"
        contents["juncs"] = "\n".join(case.juncs_lines) + "\n"
    for key, text in contents.items():
        with open(paths[key], "w") as f:
            f.write(text)
    return paths


# ------------------------------------------------- external-tool recipes

def simulate_pe_commands(
    fasta: str,
    ref: str,
    sample_name: str = "test",
    coverage: int = 30,
    read_length: int = 150,
    insertion: int = 350,
    purity: float = 1.0,
    normal_bam: Optional[str] = None,
) -> List[List[str]]:
    """wgsim + bwa + samtools pipeline (bfb_scripts.py:51-92)."""
    n_pairs = "%d" % (coverage * 3_000_000 // (2 * read_length))
    cmds = [
        ["wgsim", "-1", str(read_length), "-2", str(read_length), "-d", str(insertion), "-N", n_pairs, "-e", "0.001", fasta, sample_name + "_1.fq", sample_name + "_2.fq"],
        ["bwa", "mem", "-t", "8", ref, sample_name + "_1.fq", sample_name + "_2.fq", "-o", sample_name + ".sam"],
        ["samtools", "sort", sample_name + ".sam", "-o", sample_name + ".bam"],
        ["samtools", "index", sample_name + ".bam"],
    ]
    if purity < 1 and normal_bam:
        cmds.append(["samtools", "merge", "-f", sample_name + "_mix.bam", sample_name + ".bam", normal_bam])
    return cmds


def simulate_pb_commands(fasta: str, ref: str, sample_name: str = "test", coverage: int = 30) -> List[List[str]]:
    """pbsim3 + ngmlr pipeline (bfb_scripts.py:93-128)."""
    return [
        ["pbsim", "--strategy", "wgs", "--method", "qshmm", "--depth", str(coverage), "--genome", fasta, "--prefix", sample_name],
        ["ngmlr", "-t", "8", "-r", ref, "-q", sample_name + "_0001.fastq", "-o", sample_name + ".sam", "-x", "pacbio"],
        ["samtools", "sort", sample_name + ".sam", "-o", sample_name + ".bam"],
        ["samtools", "index", sample_name + ".bam"],
    ]


def simulate_ont_commands(fasta: str, ref: str, sample_name: str = "test", coverage: int = 30) -> List[List[str]]:
    """ONT flavor of the long-read pipeline (bfb_scripts.py:129-165)."""
    cmds = simulate_pb_commands(fasta, ref, sample_name, coverage)
    cmds[1] = ["ngmlr", "-t", "8", "-r", ref, "-q", sample_name + "_0001.fastq", "-o", sample_name + ".sam", "-x", "ont"]
    return cmds


def simulate_10x_commands(fasta: str, ref: str, sample_name: str = "test", coverage: int = 30) -> List[List[str]]:
    """LRSIM + longranger pipeline (bfb_scripts.py:166-208)."""
    return [
        ["simulateLinkedReads", "-g", fasta, "-p", sample_name, "-x", str(coverage)],
        ["longranger", "align", "--id=%s" % sample_name, "--fastqs=."],
    ]


def run_commands(cmds: Sequence[Sequence[str]]) -> None:
    for cmd in cmds:
        if shutil.which(cmd[0]) is None:
            raise RuntimeError(
                "external tool '%s' not found; install it or use "
                "simulate_bfb_case for aligner-free simulation" % cmd[0]
            )
    for cmd in cmds:
        subprocess.run(list(cmd), check=True)
