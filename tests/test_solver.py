import os

import numpy as np
import pytest

from ambigram_tpu.engine.ilp import build_bfb_program
from ambigram_tpu.engine.junccn import get_junc_cn
from ambigram_tpu.model.genome import Genome
from ambigram_tpu.scripts.simulate import random_bfb_program
from ambigram_tpu.solver.exact import solve_exact
from ambigram_tpu.solver.score import PENALTY, score_batch_jit, scoring_tensors
from ambigram_tpu.solver.search import lp_lower_bound, solve_device

DATA = os.path.join(os.path.dirname(__file__), "data")


def _egfr_prog():
    g = Genome.from_lh(os.path.join(DATA, "egfr6.lh"))
    g.calculate_hap_depth()
    g.calculate_copy_num()
    _, junc_cn = get_junc_cn(g, 1, 6)
    seg_cn = np.array([s.weight.copy_num for s in g.segments])
    return build_bfb_program(1, 6, seg_cn, junc_cn[1:7, 1], seg_cn.sum(), 1)


def _random_prog(rng, n):
    return random_bfb_program(rng, n)


def test_exact_egfr6():
    prog = _egfr_prog()
    res = solve_exact(prog)
    assert res.status == "optimal"
    assert res.epsilon_sum == pytest.approx(1.0)
    assert res.objective == pytest.approx(0.0)
    # the hand-derived optimum: loops (1,6), (2,6), (2,4), (3,4)
    from ambigram_tpu.engine.enumerate import pair_index

    T = len(prog.pairs)
    expected = np.zeros(2 * T, dtype=np.int64)
    for ij in [(1, 6), (2, 6), (2, 4), (3, 4)]:
        expected[T + pair_index(1, 6, *ij)] = 1
    assert np.array_equal(res.x, expected)


def test_score_batch_matches_numpy():
    prog = _egfr_prog()
    st = scoring_tensors(prog)
    rng = np.random.default_rng(0)
    B = 16
    Vp = st.H.shape[1]
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 3, size=(B, prog.num_vars))
    scores = np.asarray(score_batch_jit(st, X))
    for b in range(B):
        x = X[b, : prog.num_vars].astype(np.float64)
        expect = prog.residual_objective(x) + 1024.0 * prog.hard_violation(x)
        assert scores[b] == pytest.approx(expect, rel=1e-5)


def test_int8_device_expansion_matches_host_assembly():
    """scoring_tensors' int8-only device path (ship H8, expand the f32
    representation on device — solver/score.py _expand_f32) must be
    bitwise identical to the host f32 assembly, tensors and scores."""
    import jax

    prog = _egfr_prog()
    st_dev = scoring_tensors(prog)  # int8-exact: device expansion path
    assert st_dev.use_int8
    st_host = jax.device_put(scoring_tensors(prog, device=False))
    for name in ("H", "lb", "ub", "x_ub", "H8", "lb_raw", "ub_raw", "w"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st_dev, name)),
            np.asarray(getattr(st_host, name)),
            err_msg=name,
        )
    rng = np.random.default_rng(2)
    X = np.zeros((32, st_dev.H.shape[1]), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 3, size=(32, prog.num_vars))
    np.testing.assert_array_equal(
        np.asarray(score_batch_jit(st_dev, X)),
        np.asarray(score_batch_jit(st_host, X)),
    )


def test_lp_lower_bound_egfr6():
    prog = _egfr_prog()
    lb = lp_lower_bound(prog)
    assert lb is not None
    assert lb <= 1.0 + 1e-9


def test_device_search_finds_exact_optimum_egfr6():
    prog = _egfr_prog()
    res_exact = solve_exact(prog)
    res_dev = solve_device(prog)
    assert res_dev.epsilon_sum == pytest.approx(res_exact.epsilon_sum)
    assert float(prog.hard_violation(res_dev.x.astype(float))) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_search_matches_exact_random(seed):
    rng = np.random.default_rng(seed)
    prog = _random_prog(rng, n=rng.integers(4, 8))
    res_exact = solve_exact(prog)
    assert res_exact.status == "optimal"
    res_dev = solve_device(prog)
    assert float(prog.hard_violation(res_dev.x.astype(float))) == 0.0
    assert res_dev.epsilon_sum == pytest.approx(res_exact.epsilon_sum, abs=1e-6)


def _bnb_or_skip():
    from ambigram_tpu.native import bnb_available

    if not bnb_available():
        pytest.skip("native bnb_solver unavailable (no C++ toolchain)")


def test_native_bnb_egfr6_matches_exact():
    _bnb_or_skip()
    from ambigram_tpu.solver.native_bnb import solve_native

    prog = _egfr_prog()
    res = solve_native(prog)
    assert res is not None and res.status == "optimal"
    assert res.epsilon_sum == pytest.approx(1.0)
    assert float(prog.hard_violation(res.x.astype(float))) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_native_bnb_matches_exact_random(seed):
    _bnb_or_skip()
    from ambigram_tpu.solver.native_bnb import solve_native

    rng = np.random.default_rng(seed + 100)
    prog = _random_prog(rng, n=rng.integers(4, 8))
    res_exact = solve_exact(prog)
    assert res_exact.status == "optimal"
    res = solve_native(prog)
    assert res is not None and res.status == "optimal"
    assert res.epsilon_sum == pytest.approx(res_exact.epsilon_sum, abs=1e-6)
    assert float(prog.hard_violation(res.x.astype(float))) == 0.0


def test_native_bnb_warm_start_from_device_search():
    _bnb_or_skip()
    from ambigram_tpu.solver.native_bnb import solve_native

    prog = _egfr_prog()
    warm = solve_device(prog)
    res = solve_native(prog, warm=warm)
    assert res is not None and res.status == "optimal"
    assert res.epsilon_sum == pytest.approx(1.0)


def test_native_bnb_node_cap_reports_heuristic():
    _bnb_or_skip()
    from ambigram_tpu.solver.native_bnb import solve_native

    rng = np.random.default_rng(7)
    prog = _random_prog(rng, n=7)
    warm = solve_device(prog)
    res = solve_native(prog, warm=warm, node_cap=3)
    assert res is not None
    # warm incumbent is kept but the search was truncated
    assert res.status == "heuristic"
    assert res.epsilon_sum == pytest.approx(warm.epsilon_sum, abs=1e-6)
    # without any incumbent the truncated search is inconclusive, not infeasible
    res2 = solve_native(prog, node_cap=3)
    assert res2 is not None and res2.status == "error"


def test_int8_scoring_path_exact():
    """The int8 representation (doubled FBI rows + post-hinge weights)
    must equal the f64 reference objective exactly for in-range
    candidates."""
    prog = _egfr_prog()
    st = scoring_tensors(prog)
    assert st.int8_ok  # all row entries are small integers after doubling
    assert st.use_int8  # EGFR CN sums fit the int8 candidate box
    rng = np.random.default_rng(5)
    B = 32
    Vp = st.H.shape[1]
    X = np.zeros((B, Vp), dtype=np.float32)
    X[:, : prog.num_vars] = rng.integers(0, 6, size=(B, prog.num_vars))
    got = np.asarray(score_batch_jit(st, X))
    xf = X[:, : prog.num_vars].astype(np.float64)
    want = prog.residual_objective(xf) + PENALTY * prog.hard_violation(xf)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_greedy_peel_seed_decomposes_profile():
    """On a noiseless loop-decomposable profile the peel seed must fit
    the segment CNs exactly (zero segment residual)."""
    from ambigram_tpu.solver.search import greedy_peel_seed

    n = 10
    T = n * (n + 1) // 2
    from ambigram_tpu.engine.enumerate import pair_index

    truth = np.zeros(2 * T)
    for (i, j), cnt in [((1, 10), 2), ((2, 6), 1), ((4, 10), 3)]:
        truth[T + pair_index(1, n, i, j)] = cnt
    seg = np.zeros(n)
    for (i, j), cnt in [((1, 10), 2), ((2, 6), 1), ((4, 10), 3)]:
        seg[i - 1 : j] += 2 * cnt
    prog = build_bfb_program(1, n, seg, np.zeros(n), seg.sum(), 1)
    x = greedy_peel_seed(prog)
    seg_res = np.abs(x.astype(np.float64) @ prog.A_seg.T - prog.c_seg).sum()
    assert seg_res == 0.0
    assert (x >= 0).all() and (x <= prog.x_ub).all()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sweep_delta_matches_sweep(seed):
    """The incremental delta sweep must reproduce the materializing
    sweep exactly: same move scores, same applied moves, same hx."""
    import jax.numpy as jnp

    from ambigram_tpu.solver.score import row_values
    from ambigram_tpu.solver.search import _seed_population, _sweep, _sweep_delta

    rng = np.random.default_rng(seed)
    prog = _random_prog(rng, int(rng.integers(5, 12)))
    st = scoring_tensors(prog)
    X = jnp.asarray(
        _seed_population(prog, st.H.shape[1], np.asarray(st.x_ub), pop=8, seed=seed)
    )
    hx = row_values(X, st.H)
    from ambigram_tpu.solver.search import _score_from_hx

    scores = _score_from_hx(st, hx)
    # walk several sweeps, checking lockstep agreement
    Xa, sa = X, scores
    Xb, hxb, sb = X, hx, scores
    for _ in range(4):
        Xa, sa, imp_a = _sweep(st, Xa, sa)
        Xb, hxb, sb, imp_b = _sweep_delta(st, Xb, hxb, sb)
        assert bool(imp_a) == bool(imp_b)
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
        np.testing.assert_array_equal(np.asarray(Xa), np.asarray(Xb))
        np.testing.assert_array_equal(
            np.asarray(hxb), np.asarray(row_values(Xb, st.H))
        )
        if not bool(imp_a):
            break


def test_auto_midsize_never_compiles_device(tmp_path, monkeypatch):
    """Time-to-solution guard: programs at or under
    AUTO_EXACT_FIRST_MAX_VARS close in the in-process MILP without ever
    touching the device search (whose cold jit compile costs seconds
    per bucket shape). pe16 has V=272."""
    from ambigram_tpu.engine import pipeline
    from ambigram_tpu.scripts.simulate import simulate_bfb_case, write_case

    monkeypatch.chdir(tmp_path)

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("device search must not run for mid-size programs")

    import ambigram_tpu.solver.search as search

    monkeypatch.setattr(search, "solve_device", boom)
    case = simulate_bfb_case(seed=16, n_segments=16)
    paths = write_case(case, "pe16")
    res = pipeline.run_bfb(paths["lh"], solver="auto")
    assert res.path_strings
    from ambigram_tpu.scripts.evaluate import multiplicity_diff

    assert multiplicity_diff(case.truth_string, res.path_strings[0]) == 0


def _f32_path_egfr(x_ub: float = 5000.0):
    """EGFR program with the loop box raised past int8 and past TF32's
    exact-integer range (2048), so scoring takes the pinned-f32 path."""
    prog = _egfr_prog()
    prog.x_ub = np.full_like(prog.x_ub, x_ub)
    st = scoring_tensors(prog)
    assert not st.use_int8
    return prog, st


def _lowered_search(st):
    import jax

    from ambigram_tpu.solver.search import (
        _device_moves,
        _search,
        _seed_population,
    )

    prog = _egfr_prog()
    X0 = _seed_population(prog, st.H.shape[1], np.asarray(st.x_ub), pop=4, seed=0)
    moves, moves3, _ = _device_moves(prog, ("lowered", prog.num_vars), None)
    key = jax.random.PRNGKey(0)
    return _search.lower(st, X0, key, moves, moves3, rounds=1, max_sweeps=2)


def _lowered_local_score(st):
    import jax

    from ambigram_tpu.parallel.mesh import _local_score

    X = np.zeros((4, st.H.shape[1]), np.float32)
    return jax.jit(_local_score).lower(st.H, st.lb, st.ub, np.ones_like(st.lb), X)


def _lowered_score_batch(st):
    import jax

    from ambigram_tpu.solver.score import score_batch

    X = np.zeros((4, st.H.shape[1]), np.float32)
    return jax.jit(score_batch).lower(st, X)


@pytest.mark.parametrize(
    "lower", [_lowered_score_batch, _lowered_search, _lowered_local_score]
)
def test_f32_score_dots_pin_highest_precision(lower):
    """Every f32 dot that feeds a score is compiled at HIGHEST precision:
    on a GPU the DEFAULT may run as TF32, which rounds candidate entries
    above 2048 (solver/score.py module docstring)."""
    _, st = _f32_path_egfr()
    text = lower(st).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "no dot in the lowered program"
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


def _check_f32_exact_above_tf32_range():
    prog, st = _f32_path_egfr()
    V, Vp = prog.num_vars, st.H.shape[1]
    values = 2049.0 + 2.0 * np.arange(64)
    X = np.zeros((V * len(values), Vp), dtype=np.float32)
    rows = np.arange(len(X))
    X[rows, rows // len(values)] = np.tile(values, V)
    xf = X[:, :V].astype(np.float64)
    want = prog.residual_objective(xf) + PENALTY * prog.hard_violation(xf)
    keep = want < 2.0**23
    assert keep.sum() >= 64
    got = np.asarray(score_batch_jit(st, X[keep]))
    np.testing.assert_array_equal(got, want[keep].astype(np.float32))


def test_f32_score_exact_above_tf32_range():
    """The f32 path equals the f64 objective exactly for candidates with
    an entry above 2048 (odd values, which TF32's 10-bit mantissa cannot
    hold). A large entry violates most hard rows by thousands, times
    PENALTY, so only candidates whose exact score stays below 2^23 —
    where f32 holds every multiple of 0.5 — are compared."""
    _check_f32_exact_above_tf32_range()


@pytest.mark.gpu
def test_f32_score_exact_above_tf32_range_on_card():
    """The same check compiled for the card, where an unpinned f32 dot
    may run in TF32."""
    import jax

    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run with JAX_PLATFORMS=cuda,cpu on a card")
    with jax.default_device(gpu):
        _check_f32_exact_above_tf32_range()
