import os

import numpy as np
import pytest

from ambigram_tpu.scripts.evaluate import (
    junction_score,
    multiplicity_diff,
    parse_path_string,
    segment_multiplicity,
)
from ambigram_tpu.scripts.simulate import (
    bfb_process,
    path_stats,
    simulate_bfb_case,
    simulate_pe_commands,
    write_case,
)


def test_parse_path_string():
    steps = parse_path_string("1+2+3+|3-2-||7+")
    assert steps == [(1, "+"), (2, "+"), (3, "+"), (3, "-"), (2, "-"), (7, "+")]
    assert segment_multiplicity(steps)[3] == 2


def test_bfb_process_is_valid_walk():
    rng = np.random.default_rng(0)
    for _ in range(10):
        path = bfb_process(rng, 8, 3)
        # consecutive steps are genomically adjacent or fold back
        for k in range(len(path) - 1):
            (s1, d1), (s2, d2) = path[k], path[k + 1]
            if d1 == d2:
                assert (d1 == "+" and s2 == s1 + 1) or (d1 == "-" and s2 == s1 - 1)
            else:
                assert s1 == s2  # perfect fold-back
        # ends at a telomere or centromere boundary
        assert path[-1] in [(8, "+"), (1, "-")]


def test_simulated_case_files_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    case = simulate_bfb_case(seed=1, n_segments=6, rounds=2, n_juncs_fragments=3)
    paths = write_case(case, "sim1")
    assert os.path.exists(paths["lh"])
    from ambigram_tpu.model.genome import Genome

    g = Genome.from_lh(paths["lh"])
    assert len(g.segments) == 6
    assert [s.weight.copy_num for s in g.segments] == case.seg_cn.tolist()
    assert "juncs" in paths


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_pipeline_recovers_simulated_bfb(seed, tmp_path, monkeypatch):
    """Nested-chain cases are reference-representable: the pipeline must
    reproduce the exact truth path."""
    monkeypatch.chdir(tmp_path)
    case = simulate_bfb_case(seed=seed, n_segments=6)
    paths = write_case(case, "sim")
    from ambigram_tpu.engine.pipeline import run_bfb

    result = run_bfb(paths["lh"], solver="exact")
    predicted = result.path_strings[0]
    assert predicted, "no path produced"
    diff = multiplicity_diff(case.truth_string, predicted)
    assert diff == 0, (case.truth_string, predicted)
    score = junction_score(case.truth_string, predicted)
    assert score.recall == 1.0 and score.precision == 1.0


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_pipeline_on_raw_bfb_process(seed, tmp_path, monkeypatch):
    """Raw break-fusion-bridge rounds can exceed the reference model's
    nesting caps; the engine must still produce a near-fitting path."""
    monkeypatch.chdir(tmp_path)
    case = simulate_bfb_case(seed=seed, n_segments=6, rounds=2, mode="process")
    paths = write_case(case, "sim")
    from ambigram_tpu.engine.pipeline import run_bfb

    result = run_bfb(paths["lh"], solver="exact")
    predicted = result.path_strings[0]
    assert predicted
    assert multiplicity_diff(case.truth_string, predicted) <= 3


def test_generate_seg_and_lh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    case = simulate_bfb_case(seed=2, n_segments=6, rounds=2)
    paths = write_case(case, "sim2")
    from ambigram_tpu.scripts.prep import generate_lh, generate_seg

    # no BAM -> depth stub (reference bfb_scripts.py:443-447)
    seg_path = generate_seg(paths["sv"], None, sample_name="stub")
    assert os.path.exists(seg_path)
    text = open(seg_path).read()
    assert "\t100" in text
    # generate LH from the simulator's own seg file (values are CN-ish)
    lh_path = generate_lh(paths["sv"], paths["seg"], sample_name="sim2lh")
    from ambigram_tpu.io.lh import parse_lh

    lh = parse_lh(lh_path)
    assert len(lh.segs) == 6
    assert lh.source_ids == [1]
    assert lh.sink_ids == [6]
    assert len(lh.juncs) >= 1


def test_cluster_sv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sv = (
        "chrom_5p\tbkpos_5p\tstrand_5p\tchrom_3p\tbkpos_3p\tstrand_3p\tavg_cn\n"
        "chr1\t1000\t+\tchr1\t1000\t-\t2\n"  # FBI cluster A
        "chr1\t2000\t-\tchr1\t2000\t+\t1\n"
        "chr9\t500000000\t+\tchr9\t500000001\t+\t1\n"  # far away, no FBI
    )
    p = tmp_path / "sv.txt"
    p.write_text(sv)
    from ambigram_tpu.scripts.prep import cluster_sv

    out = cluster_sv(str(p), sample_name="cl")
    assert len(out) == 1  # only the FBI-containing cluster survives
    body = open(out[0]).read()
    assert "chr1\t1000" in body and "chr9" not in body


def test_sniffles2sv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    vcf = (
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        "chr7\t1000\t1\tN\t<INV>\t.\tPASS\t"
        "PRECISE;CHR2=chr7;END=2000;STRANDS=++;SVTYPE=INV\tGT:DR:DV\t0/1:10:7\n"
    )
    p = tmp_path / "a.vcf"
    p.write_text(vcf)
    from ambigram_tpu.scripts.prep import sniffles2sv

    out = sniffles2sv(str(p), "sn")
    rows = open(out).read().splitlines()
    assert rows[0].startswith("chr_3p")
    assert rows[1].split("\t") == ["chr7", "1000", "+", "chr7", "2000", "-", "7"]


def test_om2juncs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = tmp_path / "om.txt"
    p.write_text("#hdr\n3\tx\n-2\ty\n5\tz\n")
    from ambigram_tpu.scripts.prep import om2juncs

    out = om2juncs(str(p), "om")
    assert open(out).read() == "3+ 2- 5+"


def test_barcode2juncs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seg = "\n".join("chr1:%d-%d\t2" % (i * 1000 + 1, (i + 1) * 1000) for i in range(4))
    (tmp_path / "seg.txt").write_text(seg + "\n")
    # barcodes spanning segments 1..3 heavily, 1..2 lightly
    bed_lines = []
    for k in range(6):
        bed_lines.append("chr1\t500\t3000\tBC%d" % k)  # spans segs 1-3
    bed_lines.append("chr1\t500\t2000\tBX")
    (tmp_path / "bc.bed").write_text("\n".join(bed_lines) + "\n")
    from ambigram_tpu.scripts.barcode import barcode2juncs

    out = barcode2juncs(str(tmp_path / "seg.txt"), str(tmp_path / "bc.bed"), str(tmp_path / "o.juncs"))
    lines = open(out).read().splitlines()
    assert lines[0] == "1+ 2+ 3+"  # strongest link (6 barcodes x span 2)


def test_simulate_pe_commands_shape():
    cmds = simulate_pe_commands("bfb.fa", "ref.fa", "s", coverage=30)
    assert cmds[0][0] == "wgsim"
    assert any(c[0] == "bwa" for c in cmds)


def test_barcode_snap_matches_reference_semantics(tmp_path):
    """Differential check of the vectorized interval snapping against a
    straight transcription of the reference's iteration
    (process_barcode.py:13-49), on randomized inputs covering the
    first/last-segment special cases and ties."""
    import numpy as np

    from ambigram_tpu.scripts.barcode import read_barcode

    rng = np.random.default_rng(42)
    segs = []
    pos = 100
    for chrom in ("chr1", "chr1", "chr1", "chr2", "chr2"):
        segs.append([chrom, pos, pos + 99, len(segs) + 1])
        pos += 100

    def reference_groups(rows):
        group = [[] for _ in segs]
        for chrom, pos1, pos2, code in rows:
            if chrom[0] != "c":
                chrom = "chr" + chrom
            start = end = -1
            min1 = min2 = float("inf")
            for i, seg in enumerate(segs):
                if chrom != seg[0]:
                    continue
                if i == 0 and pos1 <= seg[1]:
                    start = i
                elif i == len(segs) - 1 and pos2 >= seg[2]:
                    end = i
                else:
                    if abs(seg[1] - pos1) < min1:
                        start = i
                        min1 = abs(seg[1] - pos1)
                    if abs(seg[2] - pos2) < min2:
                        end = i
                        min2 = abs(seg[2] - pos2)
            if start > end or not (0 <= start < len(segs)) or not (0 <= end < len(segs)):
                continue
            for i in range(start, end + 1):
                group[i].append(code)
        return group

    rows = []
    for k in range(300):
        chrom = rng.choice(["chr1", "chr2", "1", "chrX"])
        a = int(rng.integers(0, 700))
        b = a + int(rng.integers(1, 400))
        rows.append((str(chrom), a, b, "BC%03d" % k))

    bed = tmp_path / "r.bed"
    bed.write_text("".join("%s\t%d\t%d\t%s\n" % r for r in rows))
    assert read_barcode(str(bed), segs) == reference_groups(rows)


def test_bench_docs_extract_and_render():
    """bench_docs parses metric lines from raw bench output and from a
    driver artifact, and renders doc blocks containing exactly the
    measured numbers, on the card the primary line names."""
    import json

    from ambigram_tpu.scripts.bench_docs import (
        extract_metrics,
        render_architecture_block,
        render_readme_block,
    )

    prim = {
        "metric": "bfb_candidates_scored_per_sec_per_chip",
        "value": 123.0,
        "unit": "candidates/s",
        "vs_baseline": 2.0,
        "kernel_path": "xla-loop-int8",
        "device": {
            "platform": "gpu",
            "kind": "NVIDIA H100 80GB HBM3",
            "count": 1,
            "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W",
        },
    }
    suite = {
        "metric": "suite_seconds_large_cases",
        "cases": "4xS48 noise=0.05",
        "device_compile_seconds": 1.0,
        "device": {"seconds": 10.0, "eps_sum": 5.0, "solved": 4, "stages": {"score": 1.0}},
        "auto": {"seconds": 9.0, "eps_sum": 5.0, "solved": 4, "stages": {"solve.lns": 6.0}},
        "exact": {"seconds": 30.0, "eps_sum": 5.0, "solved": 4},
    }
    raw = "noise\n%s\n%s\n" % (json.dumps(prim), json.dumps(suite))
    m = extract_metrics(raw)
    assert set(m) == {prim["metric"], suite["metric"]}

    # driver-artifact form: stdout lines live in "tail"
    artifact = json.dumps({"n": 3, "rc": 0, "tail": raw, "parsed": prim})
    m2 = extract_metrics(artifact)
    assert prim["metric"] in m2 and suite["metric"] in m2

    readme = render_readme_block(m)
    assert "xla-loop-int8" in readme and "| auto | 9.0 | 5.00 | 4/4 |" in readme
    assert "1 x NVIDIA H100 80GB HBM3, power limit 700.00 W" in readme
    arch = render_architecture_block(m)
    assert "auto 9.0 s / device 10.0 s" in arch
    assert "1 x NVIDIA H100 80GB HBM3, power limit 700.00 W" in arch


def test_bench_docs_degenerate_artifacts():
    """Robustness: a driver artifact with a null tail must not crash
    (the parsed metric is still extracted), and a suite dict with a
    missing leg must not render a ratio against a bogus divisor."""
    import json

    from ambigram_tpu.scripts.bench_docs import (
        extract_metrics,
        render_architecture_block,
    )

    prim = {"metric": "bfb_candidates_scored_per_sec_per_chip", "value": 1.0}
    m = extract_metrics(json.dumps({"rc": 0, "tail": None, "parsed": prim}))
    assert prim["metric"] in m

    # device leg absent: the block must render without any speed claims
    partial = {
        "suite_seconds_large_cases": {
            "metric": "suite_seconds_large_cases",
            "auto": {"seconds": 9.0, "eps_sum": 5.0},
            "exact": {"seconds": 30.0, "eps_sum": 5.0},
        }
    }
    arch = render_architecture_block(partial)
    assert "x the speed" not in arch
