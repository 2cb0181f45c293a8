"""Device-resident search over candidate BFB structures.

Population steepest-descent over the +-1 move neighborhood, scored by
the batched matmul scorer (ambigram_tpu.solver.score). Each sweep
evaluates every single-variable move of every population member —
tens of thousands of candidate structures per step, all on the device —
in place of cbc's branch and bound on this problem family.

Optimality certification: the integer optimum is lower-bounded by the
LP relaxation (continuous x). When the search result meets the LP
bound it is provably optimal ("optimal" status); otherwise the result
is returned as "heuristic" and the pipeline's auto mode falls back to
the exact solver (ambigram_tpu.solver.exact).

A full device branch-and-bound with PDHG dual bounds is the planned
follow-up; this module's search is already the throughput path the
BASELINE metric measures.

Sweeps are scored incrementally (`_sweep_delta`): the row values
hx = Hx are threaded through the descent and each move costs one
column delta, ~1000x less arithmetic than re-scoring, with bitwise
identical move selection (lockstep-tested against the materializing
`_sweep`). When +-1 descent stalls, paired moves (`_sweep_moves`:
endpoint slides and loop<->pattern transfers) cross valleys single
moves cannot.

Known quality frontier (measured): at S>=32 the search still plateaus
above the true optimum on noisy synthetic profiles (e.g. eps 21-22 vs
exact 18-20 territory at S=32; the LP bound is far weaker still, so
certificates rarely fire there). For scale that beats the exact MILP,
which finds NO feasible point in 240s at S=48; the auto pipeline
covers the gap with the time-budgeted warm-started native B&B.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ambigram_tpu.engine.ilp import BfbProgram
from ambigram_tpu.solver.exact import SolveResult
from ambigram_tpu.solver.score import (
    ScoringTensors,
    row_values,
    score_batch,
    scoring_tensors,
)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _sweep(st: ScoringTensors, X: jnp.ndarray, scores: jnp.ndarray, chunk: int = 128):
    """One steepest-descent sweep by full candidate materialization —
    kept as the differential anchor for `_sweep_delta`, which computes
    the identical move scores incrementally. For each population
    member, find the best single +-1 move across all variables and
    apply it if it improves. Returns (X', scores', improved_any)."""
    B, Vp = X.shape
    n_chunks = Vp // chunk
    var_ids = jnp.arange(Vp).reshape(n_chunks, chunk)

    def chunk_step(carry, var_block):
        best_score, best_var, best_sign = carry
        # delta rows for this chunk: [2*chunk, Vp]
        eye = jax.nn.one_hot(var_block, Vp, dtype=X.dtype)  # [chunk, Vp]
        deltas = jnp.concatenate([eye, -eye], axis=0)  # [2*chunk, Vp]
        cand = X[:, None, :] + deltas[None, :, :]  # [B, 2C, Vp]
        cand = jnp.clip(cand, 0.0, st.x_ub)
        s = score_batch(st, cand.reshape(B * 2 * chunk, Vp)).reshape(B, 2 * chunk)
        idx = jnp.argmin(s, axis=1)  # [B]
        val = jnp.take_along_axis(s, idx[:, None], axis=1)[:, 0]
        var = var_block[idx % chunk]
        sign = jnp.where(idx < chunk, 1.0, -1.0)
        better = val < best_score
        return (
            jnp.where(better, val, best_score),
            jnp.where(better, var, best_var),
            jnp.where(better, sign, best_sign),
        ), None

    init = (scores, jnp.zeros(B, dtype=jnp.int32), jnp.zeros(B))
    (best_score, best_var, best_sign), _ = jax.lax.scan(chunk_step, init, var_ids)
    improved = best_score < scores - 1e-6
    delta = jax.nn.one_hot(best_var, Vp, dtype=X.dtype) * best_sign[:, None]
    X_new = jnp.clip(X + delta, 0.0, st.x_ub)
    X_out = jnp.where(improved[:, None], X_new, X)
    s_out = jnp.where(improved, best_score, scores)
    return X_out, s_out, jnp.any(improved)


def _score_from_hx(st: ScoringTensors, hx: jnp.ndarray) -> jnp.ndarray:
    """Hinge score given precomputed row values hx = x @ H.T."""
    over = jnp.maximum(hx - st.ub, 0.0)
    under = jnp.maximum(st.lb - hx, 0.0)
    return jnp.sum(over, axis=-1) + jnp.sum(under, axis=-1)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _sweep_delta(
    st: ScoringTensors,
    X: jnp.ndarray,
    hx: jnp.ndarray,
    scores: jnp.ndarray,
    chunk: int = 128,
):
    """`_sweep` computed incrementally: score(x +- e_v) needs only the
    current row values hx = x @ H.T and the column H[:, v], so one sweep
    is a [B, Rows, chunk] broadcast-reduce instead of 2*Vp full matmul
    scorings — ~1000x less arithmetic for the same (bitwise identical:
    every quantity is an exact small multiple of 0.5 in f32) move
    scores and the same first-minimum tie-breaking. hx is threaded and
    updated by the applied move's column. Returns
    (X', hx', scores', improved_any)."""
    B, Vp = X.shape
    n_chunks = Vp // chunk
    var_ids = jnp.arange(Vp).reshape(n_chunks, chunk)

    def chunk_step(carry, var_block):
        best_score, best_var, best_sign = carry
        Hc = st.H[:, var_block]  # [Rows, chunk]
        base = hx[:, :, None]  # [B, Rows, 1]
        lb = st.lb[None, :, None]
        ub = st.ub[None, :, None]

        def hinge_sum(delta):  # delta: [1, Rows, chunk]
            v = base + delta
            return jnp.sum(
                jnp.maximum(v - ub, 0.0) + jnp.maximum(lb - v, 0.0), axis=1
            )

        s_plus = hinge_sum(Hc[None])  # [B, chunk]
        s_minus = hinge_sum(-Hc[None])
        # moves that clip back to X score exactly the current score
        # (cand = clip(X +- e_v) = X in `_sweep`), so they never win
        xv = X[:, var_block]
        ub_v = st.x_ub[var_block][None, :]
        s_plus = jnp.where(xv + 1.0 > ub_v, scores[:, None], s_plus)
        s_minus = jnp.where(xv - 1.0 < 0.0, scores[:, None], s_minus)
        s = jnp.concatenate([s_plus, s_minus], axis=1)  # [B, 2*chunk]
        idx = jnp.argmin(s, axis=1)
        val = jnp.take_along_axis(s, idx[:, None], axis=1)[:, 0]
        var = var_block[idx % chunk]
        sign = jnp.where(idx < chunk, 1.0, -1.0)
        better = val < best_score
        return (
            jnp.where(better, val, best_score),
            jnp.where(better, var, best_var),
            jnp.where(better, sign, best_sign),
        ), None

    init = (scores, jnp.zeros(B, dtype=jnp.int32), jnp.zeros(B))
    (best_score, best_var, best_sign), _ = jax.lax.scan(chunk_step, init, var_ids)
    improved = best_score < scores - 1e-6
    delta = jax.nn.one_hot(best_var, Vp, dtype=X.dtype) * best_sign[:, None]
    X_out = jnp.where(improved[:, None], jnp.clip(X + delta, 0.0, st.x_ub), X)
    col = jnp.take(st.H, best_var, axis=1).T  # [B, Rows]
    hx_out = jnp.where(improved[:, None], hx + best_sign[:, None] * col, hx)
    s_out = jnp.where(improved, best_score, scores)
    return X_out, hx_out, s_out, jnp.any(improved)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _sweep_moves(
    st: ScoringTensors,
    X: jnp.ndarray,
    hx: jnp.ndarray,
    scores: jnp.ndarray,
    mv_minus: jnp.ndarray,
    mv_plus: jnp.ndarray,
    chunk: int = 128,
):
    """Paired-move sweep: each move m transfers one unit from variable
    mv_minus[m] to mv_plus[m] (endpoint slides l(i,j)->l(i+-1,j)/
    l(i,j+-1), loop<->pattern transfers). Scored incrementally via the
    column delta H[:,plus]-H[:,minus]; these moves cross the valleys
    the +-1 neighborhood cannot (shifting a whole loop boundary is two
    coupled +-1 moves). Same apply-best-if-improves semantics as
    `_sweep_delta`."""
    B, Vp = X.shape
    M = mv_minus.shape[0]
    n_chunks = M // chunk
    move_ids = jnp.arange(M).reshape(n_chunks, chunk)

    def chunk_step(carry, move_block):
        best_score, best_move = carry
        mm = mv_minus[move_block]
        mp = mv_plus[move_block]
        Dc = st.H[:, mp] - st.H[:, mm]  # [Rows, chunk]
        v = hx[:, :, None] + Dc[None, :, :]
        s = jnp.sum(
            jnp.maximum(v - st.ub[None, :, None], 0.0)
            + jnp.maximum(st.lb[None, :, None] - v, 0.0),
            axis=1,
        )  # [B, chunk]
        valid = (X[:, mm] >= 1.0) & (X[:, mp] + 1.0 <= st.x_ub[mp][None, :])
        s = jnp.where(valid, s, scores[:, None])
        idx = jnp.argmin(s, axis=1)
        val = jnp.take_along_axis(s, idx[:, None], axis=1)[:, 0]
        move = move_block[idx]
        better = val < best_score
        return (
            jnp.where(better, val, best_score),
            jnp.where(better, move, best_move),
        ), None

    init = (scores, jnp.zeros(B, dtype=jnp.int32))
    (best_score, best_move), _ = jax.lax.scan(chunk_step, init, move_ids)
    improved = best_score < scores - 1e-6
    bm_minus = mv_minus[best_move]
    bm_plus = mv_plus[best_move]
    delta = jax.nn.one_hot(bm_plus, Vp, dtype=X.dtype) - jax.nn.one_hot(
        bm_minus, Vp, dtype=X.dtype
    )
    X_out = jnp.where(improved[:, None], X + delta, X)
    col = (jnp.take(st.H, bm_plus, axis=1) - jnp.take(st.H, bm_minus, axis=1)).T
    hx_out = jnp.where(improved[:, None], hx + col, hx)
    s_out = jnp.where(improved, best_score, scores)
    return X_out, hx_out, s_out, jnp.any(improved)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _sweep_moves3(
    st: ScoringTensors,
    X: jnp.ndarray,
    hx: jnp.ndarray,
    scores: jnp.ndarray,
    mv_a: jnp.ndarray,
    mv_b: jnp.ndarray,
    mv_c: jnp.ndarray,
    mv_s: jnp.ndarray,
    mv_valid: jnp.ndarray,
    chunk: int = 128,
):
    """Triple-move sweep: move m applies x[a] -= s, x[b] += s,
    x[c] += s with s in {+1, -1} — the split (s=+1: one loop/pattern
    becomes its two halves) and merge (s=-1) coordinated moves that
    target the search's known plateau structure (retiming a fold
    boundary is THREE coupled +-1 moves, invisible to the single and
    paired neighborhoods). Scored incrementally via the column delta
    s * (H[:, b] + H[:, c] - H[:, a]); same apply-best-if-improves
    semantics as `_sweep_delta`. `mv_valid` masks padding entries."""
    B, Vp = X.shape
    M = mv_a.shape[0]
    n_chunks = M // chunk
    move_ids = jnp.arange(M).reshape(n_chunks, chunk)

    def chunk_step(carry, move_block):
        best_score, best_move = carry
        a = mv_a[move_block]
        b = mv_b[move_block]
        c = mv_c[move_block]
        s_sign = mv_s[move_block]  # [chunk]
        Dc = (st.H[:, b] + st.H[:, c] - st.H[:, a]) * s_sign[None, :]
        v = hx[:, :, None] + Dc[None, :, :]
        s = jnp.sum(
            jnp.maximum(v - st.ub[None, :, None], 0.0)
            + jnp.maximum(st.lb[None, :, None] - v, 0.0),
            axis=1,
        )  # [B, chunk]
        pos = s_sign > 0
        # split validity: x[a] >= 1 and both halves below their bounds
        # (b may equal c — an overlap split never does, but guard by
        # requiring headroom 2 when they coincide)
        need_bc = jnp.where(b == c, 2.0, 1.0)
        ok_split = (
            (X[:, a] >= 1.0)
            & (X[:, b] + need_bc <= st.x_ub[b][None, :])
            & (X[:, c] + 1.0 <= st.x_ub[c][None, :])
        )
        ok_merge = (
            (X[:, b] >= need_bc)
            & (X[:, c] >= 1.0)
            & (X[:, a] + 1.0 <= st.x_ub[a][None, :])
        )
        valid = jnp.where(pos[None, :], ok_split, ok_merge) & mv_valid[move_block][None, :]
        s = jnp.where(valid, s, scores[:, None])
        idx = jnp.argmin(s, axis=1)
        val = jnp.take_along_axis(s, idx[:, None], axis=1)[:, 0]
        move = move_block[idx]
        better = val < best_score
        return (
            jnp.where(better, val, best_score),
            jnp.where(better, move, best_move),
        ), None

    init = (scores, jnp.zeros(B, dtype=jnp.int32))
    (best_score, best_move), _ = jax.lax.scan(chunk_step, init, move_ids)
    improved = best_score < scores - 1e-6
    ba = mv_a[best_move]
    bb = mv_b[best_move]
    bc = mv_c[best_move]
    bs = mv_s[best_move]
    delta = (
        jax.nn.one_hot(bb, Vp, dtype=X.dtype)
        + jax.nn.one_hot(bc, Vp, dtype=X.dtype)
        - jax.nn.one_hot(ba, Vp, dtype=X.dtype)
    ) * bs[:, None]
    X_out = jnp.where(improved[:, None], X + delta, X)
    col = (
        jnp.take(st.H, bb, axis=1)
        + jnp.take(st.H, bc, axis=1)
        - jnp.take(st.H, ba, axis=1)
    ).T * bs[:, None]
    hx_out = jnp.where(improved[:, None], hx + col, hx)
    s_out = jnp.where(improved, best_score, scores)
    return X_out, hx_out, s_out, jnp.any(improved)


def split_merge_moves(
    prog: BfbProgram, pad_to: int = 512, max_moves: int = 262144
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The triple-move catalogue for `_sweep_moves3`, three families per
    (i, j, k):

    - contiguous loop split/merge   l(i,j) <-> l(i,k) + l(k+1,j)
    - overlapping loop split/merge  l(i,j) <-> l(i,k) + l(k,j)
      (double-covers segment k — the +-1-CN repair move under noise)
    - pattern split/merge           p(i,j) <-> p(i,k) + p(k+1,j)

    Each family preserves segment coverage (the overlap one up to +1 on
    one segment) while re-timing the fold boundary, which moves the FBI
    rows — precisely the coordinated change the plateau needs. O(n^3)
    triples; above `max_moves` the split point k is strided so the set
    stays bounded (coverage note: stride > 1 drops some exact split
    points — the +-1 sweeps recover them from a near miss). For
    single-cell block programs the set replicates per clone block.
    Returns (a, b, c, sign, valid) padded to a multiple of `pad_to`."""
    from ambigram_tpu.engine.enumerate import pair_index

    T = len(prog.pairs)
    n = prog.n
    start = prog.start

    def pidx(a: int, b: int) -> int:
        return pair_index(prog.start, prog.end, a, b)

    # triple count before striding: ~3 * n^3 / 6 per sign
    est = n * n * n // 2
    stride = max(1, int(np.ceil(est / max(max_moves // 2, 1))))
    triples = []  # (a, b, c) variable-index triples, sign applied later
    for t, (i, j) in enumerate(prog.pairs):
        if j <= i:
            continue
        for k in range(int(i), int(j), stride):
            # contiguous: l(i,j) <-> l(i,k) + l(k+1,j)
            triples.append(
                (T + t, T + pidx(int(i), k), T + pidx(k + 1, int(j)))
            )
            # pattern: p(i,j) <-> p(i,k) + p(k+1,j)
            triples.append((t, pidx(int(i), k), pidx(k + 1, int(j))))
            if k > int(i):
                # overlapping: l(i,j) <-> l(i,k) + l(k,j)
                triples.append(
                    (T + t, T + pidx(int(i), k), T + pidx(k, int(j)))
                )
    base = (
        np.asarray(triples, dtype=np.int32)
        if triples
        else np.zeros((0, 3), np.int32)
    )
    K = prog.num_vars // (2 * T) if T else 1
    if K > 1 and len(base):
        base = np.concatenate([base + k * 2 * T for k in range(K)], axis=0)
    # both signs per triple
    n_t = len(base)
    M = ((2 * n_t + pad_to - 1) // pad_to) * pad_to if n_t else pad_to
    a = np.zeros(M, dtype=np.int32)
    b = np.zeros(M, dtype=np.int32)
    c = np.zeros(M, dtype=np.int32)
    s = np.ones(M, dtype=np.float32)
    valid = np.zeros(M, dtype=bool)
    if n_t:
        a[: 2 * n_t] = np.concatenate([base[:, 0], base[:, 0]])
        b[: 2 * n_t] = np.concatenate([base[:, 1], base[:, 1]])
        c[: 2 * n_t] = np.concatenate([base[:, 2], base[:, 2]])
        s[n_t : 2 * n_t] = -1.0
        valid[: 2 * n_t] = True
    return a, b, c, s, valid


def slide_transfer_moves(prog: BfbProgram, pad_to: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """The paired-move set for `_sweep_moves`: endpoint slides for every
    pattern and loop, plus loop<->pattern transfers at the same (i,j).
    For single-cell block programs the set is replicated per clone
    block (each clone slides its own copies). Padded with null (0,0)
    moves (zero delta — never strictly better)."""
    from ambigram_tpu.engine.enumerate import pair_index

    T = len(prog.pairs)
    moves = []
    for t, (i, j) in enumerate(prog.pairs):
        for off in (0, T):
            v = off + t
            for ni, nj in ((i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)):
                if prog.start <= ni <= nj <= prog.end:
                    nb = off + pair_index(prog.start, prog.end, ni, nj)
                    moves.append((v, nb))
        moves.append((T + t, t))
        moves.append((t, T + t))
    base = np.asarray(moves, dtype=np.int32) if moves else np.zeros((0, 2), np.int32)
    K = prog.num_vars // (2 * T) if T else 1
    if K > 1 and len(base):
        base = np.concatenate([base + k * 2 * T for k in range(K)], axis=0)
    M = ((len(base) + pad_to - 1) // pad_to) * pad_to if len(base) else pad_to
    mv = np.zeros((M, 2), dtype=np.int32)
    if len(base):
        mv[: len(base)] = base
    return mv[:, 0], mv[:, 1]


def _descend_loop(
    st: ScoringTensors,
    X,
    hx,
    scores,
    max_sweeps: int,
    chunk: int,
    moves=None,
    moves3=None,
):
    """Tiered descent: single-variable sweeps while they improve; when
    they stall, one paired-move sweep; when BOTH stall, one triple-move
    sweep (splits/merges). Any lower tier's success resumes tier 1, so
    the expensive tiers only run at basin floors. Returns (X, hx,
    scores, n_delta_sweeps, n_move_sweeps, n_move3_sweeps) — the sweep
    counts drive the pipeline's real candidates-scored/s counter."""

    def cond(state):
        _, _, _, improved, it, _, _ = state
        return jnp.logical_and(improved, it < max_sweeps)

    def body(state):
        X, hx, scores, _, it, n_mv, n_m3 = state
        X, hx, scores, imp1 = _sweep_delta(st, X, hx, scores, chunk=chunk)
        if moves is not None:
            # paired moves only when +-1 descent stalls: they matter at
            # the basin floor, and this keeps the per-iteration cost of
            # the long descent phase at one sweep
            def with_moves(args):
                X, hx, scores = args
                return _sweep_moves(st, X, hx, scores, moves[0], moves[1], chunk=chunk)

            def without(args):
                X, hx, scores = args
                return X, hx, scores, jnp.bool_(False)

            X, hx, scores, imp2 = jax.lax.cond(
                imp1, without, with_moves, (X, hx, scores)
            )
            n_mv = n_mv + jnp.where(imp1, 0, 1)
            imp1 = jnp.logical_or(imp1, imp2)
        if moves3 is not None:
            # triple moves (split/merge) are the costliest sweep — run
            # only when tiers 1-2 both stalled
            def with_m3(args):
                X, hx, scores = args
                return _sweep_moves3(
                    st, X, hx, scores, *moves3, chunk=chunk
                )

            def without3(args):
                X, hx, scores = args
                return X, hx, scores, jnp.bool_(False)

            X, hx, scores, imp3 = jax.lax.cond(
                imp1, without3, with_m3, (X, hx, scores)
            )
            n_m3 = n_m3 + jnp.where(imp1, 0, 1)
            imp1 = jnp.logical_or(imp1, imp3)
        return X, hx, scores, imp1, it + 1, n_mv, n_m3

    X, hx, scores, _, it, n_mv, n_m3 = jax.lax.while_loop(
        cond,
        body,
        (
            X,
            hx,
            scores,
            jnp.bool_(True),
            jnp.int32(0),
            jnp.int32(0),
            jnp.int32(0),
        ),
    )
    return X, hx, scores, it, n_mv, n_m3


def _search_impl(
    st: ScoringTensors,
    X: jnp.ndarray,
    key: jnp.ndarray,
    moves: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    moves3=None,
    rounds: int = 6,
    max_sweeps: int = 256,
    chunk: int = 128,
    target: float = 0.0,
    patience: int = 2,
):
    """Basin hopping: steepest descent to a local optimum, then restart
    every member from the global best with random +-1/+-2 kicks.

    `patience`: stop early after this many consecutive rounds without
    improving the global best — with the triple-move neighborhood the
    search usually lands on the optimum in the first rounds, and the LP
    bound is too weak there to signal it via `target` (measured on the
    noisy S=48 suite: optimum found, then 3-4 pure-waste rounds).

    Unjitted implementation: `_search` jits it for the per-case path;
    `solve_device_batch` jits `vmap(_search_impl)` over case-stacked
    tensors (one device program for a whole same-shape group)."""
    B, Vp = X.shape
    hx = row_values(X, st.H)
    scores = _score_from_hx(st, hx)

    def round_body(i, state):
        X, hx, scores, best_x, best_s, key, sweeps = state
        X, hx, scores, n_d, n_m, n_3 = _descend_loop(
            st, X, hx, scores, max_sweeps, chunk, moves, moves3
        )
        sweeps = (sweeps[0] + n_d, sweeps[1] + n_m, sweeps[2] + n_3)
        # fold the round's best into the global best
        idx = jnp.argmin(scores)
        round_best = scores[idx]
        take = round_best < best_s
        best_x = jnp.where(take, X[idx], best_x)
        best_s = jnp.where(take, round_best, best_s)
        # kick: half the population restarts from the global best
        # (exploitation), the other half from its OWN local minimum
        # (diversity — a strong early basin must not trap everyone);
        # member 0 stays exactly at the global best
        key, k1, k2 = jax.random.split(key, 3)
        n_kicks = 4
        vars_ = jax.random.randint(k1, (B, n_kicks), 0, Vp)
        signs = jax.random.choice(
            k2, jnp.array([-2.0, -1.0, 1.0, 2.0]), shape=(B, n_kicks)
        )
        kick = jnp.zeros((B, Vp), X.dtype)
        kick = jax.vmap(
            lambda k, v, s: k.at[v].add(s), in_axes=(0, 0, 0)
        )(kick, vars_, signs)
        kick = kick.at[0].set(0.0)
        from_best = (jnp.arange(B) % 2 == 0)[:, None]
        base = jnp.where(from_best, best_x[None, :], X)
        X = jnp.clip(base + kick, 0.0, st.x_ub)
        hx = row_values(X, st.H)
        scores = _score_from_hx(st, hx)
        return X, hx, scores, best_x, best_s, key, sweeps

    best_x = X[0]
    best_s = scores[0]
    sweeps0 = (jnp.int32(0), jnp.int32(0), jnp.int32(0))

    # basin-hop until the round budget runs out OR the incumbent meets
    # `target` — the caller passes the half-integer-rounded LP bound
    # (0 when unavailable): a feasible score at the bound is provably
    # optimal, so further rounds are pure waste
    tgt = jnp.float32(target)

    def rounds_cond(state):
        _, _, _, _, best_s, _, _, r, stagnant = state
        return jnp.logical_and(
            jnp.logical_and(r < rounds, best_s > tgt),
            stagnant <= patience,
        )

    def rounds_body(state):
        X, hx, scores, best_x, best_s, key, sweeps, r, stagnant = state
        prev_best = best_s
        X, hx, scores, best_x, best_s, key, sweeps = round_body(
            r, (X, hx, scores, best_x, best_s, key, sweeps)
        )
        stagnant = jnp.where(best_s < prev_best - 1e-6, 0, stagnant + 1)
        return X, hx, scores, best_x, best_s, key, sweeps, r + 1, stagnant

    X, hx, scores, best_x, best_s, _, sweeps, _, stagnant = jax.lax.while_loop(
        rounds_cond,
        rounds_body,
        (
            X,
            hx,
            scores,
            best_x,
            best_s,
            key,
            sweeps0,
            jnp.int32(0),
            jnp.int32(0),
        ),
    )

    # no separate final descent: best_x is folded AFTER each round's
    # descent, so it is already a local optimum of the full tiered
    # neighborhood — a second `_descend_loop` instantiation at pop 1
    # found nothing and doubled the compiled program.
    # `stagnant` tells the host WHY the loop exited: > patience means
    # the search CONVERGED (stagnation), <= patience at exit means the
    # round budget starved it — the polish stage reads this to choose
    # between a cheap probe and a full polish.
    return best_x, best_s, (sweeps[0], sweeps[1], sweeps[2]), stagnant


_search = functools.partial(jax.jit, static_argnames=("chunk",))(_search_impl)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _batch_search(
    st: ScoringTensors,  # leading case axis G on every tensor leaf
    X: jnp.ndarray,  # [G, B, Vp]
    keys: jnp.ndarray,  # [G] PRNGKeys
    moves: Tuple[jnp.ndarray, jnp.ndarray],  # shared across the group
    moves3,
    rounds: int = 6,
    max_sweeps: int = 256,
    chunk: int = 128,
    targets: jnp.ndarray = None,  # [G]
    patience: int = 2,
):
    """`_search_impl` over a case-stacked group in ONE device program.

    Per-population-member sweeps vectorize over cases trivially (a
    member only interacts with its own case's tensors), so tier-1
    sweeps are `vmap`ped. The expensive tiers are gated on BATCH-GLOBAL
    stalls with scalar `lax.cond` — a batched (per-case) cond would
    lower to running both branches every iteration, destroying the
    tiered economy. Semantics: tier 2/3 fire when NO case improved at
    the tier below this iteration; converged cases ride along with
    no-op sweeps (their state cannot regress — accepts are
    strictly-improving and the per-case best is folded after each
    round). Wall-clock is the slowest case's schedule; the payoff is
    one compile, one tensor transfer, and G*B-row matmuls instead of G
    queued B-row programs on one chip."""
    G, B, Vp = X.shape
    sweep1 = jax.vmap(
        functools.partial(_sweep_delta, chunk=chunk), in_axes=(0, 0, 0, 0)
    )
    sweep2 = jax.vmap(
        functools.partial(_sweep_moves, chunk=chunk),
        in_axes=(0, 0, 0, 0, None, None),
    )
    sweep3 = jax.vmap(
        functools.partial(_sweep_moves3, chunk=chunk),
        in_axes=(0, 0, 0, 0, None, None, None, None, None),
    )
    hx = row_values(X, st.H)  # [G, B, Rows]
    scores = jax.vmap(_score_from_hx)(st, hx)

    def descend(X, hx, scores):
        def cond(state):
            _, _, _, improved, it, _, _ = state
            return jnp.logical_and(improved, it < max_sweeps)

        def body(state):
            X, hx, scores, _, it, n_mv, n_m3 = state
            X, hx, scores, imp1 = sweep1(st, X, hx, scores)
            all1 = jnp.all(imp1)

            def with2(args):
                X, hx, scores = args
                X, hx, scores, imp2 = sweep2(
                    st, X, hx, scores, moves[0], moves[1]
                )
                return X, hx, scores, jnp.any(imp2)

            def skip(args):
                X, hx, scores = args
                return X, hx, scores, jnp.bool_(False)

            # tier 2 fires when ANY case stalled at tier 1 — it is only
            # a few times tier 1's cost, and a per-case cadence match
            # matters for quality (accepts are strictly improving, so
            # running it on still-descending cases cannot hurt them)
            X, hx, scores, any2 = jax.lax.cond(all1, skip, with2, (X, hx, scores))
            n_mv = n_mv + jnp.where(all1, 0, 1)

            def with3(args):
                X, hx, scores = args
                X, hx, scores, imp3 = sweep3(st, X, hx, scores, *moves3)
                return X, hx, scores, jnp.any(imp3)

            # tier 3 (the ~100x-cost triple sweep) only on a FULL stall
            stalled12 = jnp.logical_not(
                jnp.logical_or(jnp.any(imp1), any2)
            )
            X, hx, scores, any3 = jax.lax.cond(
                stalled12, with3, skip, (X, hx, scores)
            )
            n_m3 = n_m3 + jnp.where(stalled12, 1, 0)
            improved = jnp.logical_or(
                jnp.any(imp1), jnp.logical_or(any2, any3)
            )
            return X, hx, scores, improved, it + 1, n_mv, n_m3

        X, hx, scores, _, it, n_mv, n_m3 = jax.lax.while_loop(
            cond,
            body,
            (X, hx, scores, jnp.bool_(True), jnp.int32(0), jnp.int32(0), jnp.int32(0)),
        )
        return X, hx, scores, it, n_mv, n_m3

    best_x = X[:, 0]
    best_s = scores[:, 0]
    tgt = jnp.maximum(targets, 0.0)

    def rounds_cond(state):
        _, _, _, _, best_s, _, _, r, stagnant = state
        active = jnp.logical_and(best_s > tgt, stagnant <= patience)
        return jnp.logical_and(r < rounds, jnp.any(active))

    def rounds_body(state):
        X, hx, scores, best_x, best_s, keys, sweeps, r, stagnant = state
        prev_best = best_s
        X, hx, scores, n_d, n_m, n_3 = descend(X, hx, scores)
        sweeps = (sweeps[0] + n_d, sweeps[1] + n_m, sweeps[2] + n_3)
        idx = jnp.argmin(scores, axis=1)  # [G]
        round_best = jnp.take_along_axis(scores, idx[:, None], axis=1)[:, 0]
        take = round_best < best_s
        picked = X[jnp.arange(X.shape[0]), idx]  # [G, Vp]
        best_x = jnp.where(take[:, None], picked, best_x)
        best_s = jnp.where(take, round_best, best_s)

        def kick_case(key, X, best_x, x_ub):
            key, k1, k2 = jax.random.split(key, 3)
            n_kicks = 4
            Vp = X.shape[1]
            vars_ = jax.random.randint(k1, (X.shape[0], n_kicks), 0, Vp)
            signs = jax.random.choice(
                k2, jnp.array([-2.0, -1.0, 1.0, 2.0]), shape=(X.shape[0], n_kicks)
            )
            kick = jnp.zeros_like(X)
            kick = jax.vmap(lambda k, v, s: k.at[v].add(s))(kick, vars_, signs)
            kick = kick.at[0].set(0.0)
            from_best = (jnp.arange(X.shape[0]) % 2 == 0)[:, None]
            base = jnp.where(from_best, best_x[None, :], X)
            return key, jnp.clip(base + kick, 0.0, x_ub)

        keys, X = jax.vmap(kick_case)(keys, X, best_x, st.x_ub)
        hx = row_values(X, st.H)
        scores = jax.vmap(_score_from_hx)(st, hx)
        stagnant = jnp.where(best_s < prev_best - 1e-6, 0, stagnant + 1)
        return X, hx, scores, best_x, best_s, keys, sweeps, r + 1, stagnant

    sweeps0 = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    X, hx, scores, best_x, best_s, _, sweeps, _, stagnant = jax.lax.while_loop(
        rounds_cond,
        rounds_body,
        (
            X,
            hx,
            scores,
            best_x,
            best_s,
            keys,
            sweeps0,
            jnp.int32(0),
            jnp.zeros((G,), jnp.int32),
        ),
    )
    # per-case convergence signal (see _search_impl's return note)
    return best_x, best_s, sweeps, stagnant


def _seed_population(prog: BfbProgram, Vp: int, x_ub: np.ndarray, pop: int, seed: int) -> np.ndarray:
    T = len(prog.pairs)
    K = prog.num_vars // (2 * T) if T else 1  # clone blocks (engine/sc.py)
    X = np.zeros((pop, Vp), dtype=np.float32)
    rng = np.random.default_rng(seed)
    root = _pair_idx(prog, prog.start, prog.end)
    for blk in range(K):
        off = blk * 2 * T
        # member 0: all-zero (pure constructive descent)
        # member 1: the reference pattern p(start, end) = 1, every clone
        if pop > 1:
            X[1, off + root] = 1
        # member 2: the top loop l(start, end) = 1, every clone
        if pop > 2:
            X[2, off + T + root] = 1
        # rest: sparse random loop starts per clone
        for b in range(3, pop):
            k = rng.integers(1, 4)
            idx = rng.integers(0, T, size=k)
            X[b, off + T + idx] = rng.integers(1, 3, size=k)
    return np.minimum(X, np.asarray(x_ub, dtype=np.float32))


def _pair_idx(prog: BfbProgram, i: int, j: int) -> int:
    from ambigram_tpu.engine.enumerate import pair_index

    return pair_index(prog.start, prog.end, i, j)


def greedy_peel_seed(prog: BfbProgram) -> np.ndarray:
    """Water-level decomposition of the CN profile into loops and
    patterns — the natural constructive BFB start. Repeatedly take the
    longest run of residual CN >= 2 and subtract a loop (each loop adds
    2 per covered segment), then cover remaining runs of 1 with
    patterns. Ignores the nesting constraints (descent repairs those);
    lands near the optimum when the profile is loop-decomposable, which
    is exactly the BFB model. Single-cell block programs peel each
    clone's profile into its own block."""
    n = prog.n
    T = len(prog.pairs)
    K = prog.num_vars // (2 * T) if T else 1
    if K > 1:
        x = np.zeros(prog.num_vars, dtype=np.float32)
        for blk in range(K):
            sub = BfbProgram(
                start=prog.start,
                end=prog.end,
                pairs=prog.pairs,
                A_seg=prog.A_seg[blk * n : (blk + 1) * n, blk * 2 * T : (blk + 1) * 2 * T],
                c_seg=prog.c_seg[blk * n : (blk + 1) * n],
                A_fbi=np.zeros((0, 2 * T)),
                c_fbi=np.zeros(0),
                G=np.zeros((0, 2 * T)),
                g_lb=np.zeros(0),
                g_ub=np.zeros(0),
                x_ub=prog.x_ub[blk * 2 * T : (blk + 1) * 2 * T],
                bias=0,
            )
            x[blk * 2 * T : (blk + 1) * 2 * T] = greedy_peel_seed(sub)
        return x
    c = prog.c_seg.astype(np.float64).copy()
    x = np.zeros(prog.num_vars, dtype=np.float32)

    def longest_run(mask: np.ndarray):
        best = (0, -1, -1)  # (len, i, j)
        i = 0
        while i < n:
            if mask[i]:
                j = i
                while j + 1 < n and mask[j + 1]:
                    j += 1
                if j - i + 1 > best[0]:
                    best = (j - i + 1, i, j)
                i = j + 1
            else:
                i += 1
        return best

    for _ in range(4 * n):  # bounded; each step strictly reduces sum(c)
        ln, i, j = longest_run(c >= 2.0)
        if ln == 0:
            break
        amount = max(1.0, float(np.floor(c[i : j + 1].min() / 2.0)))
        t = T + _pair_idx(prog, prog.start + i, prog.start + j)
        amount = min(amount, float(prog.x_ub[t]) - float(x[t]))
        if amount < 1.0:
            break
        x[t] += amount
        c[i : j + 1] -= 2.0 * amount
    for _ in range(2 * n):
        ln, i, j = longest_run(c >= 1.0)
        if ln == 0:
            break
        t = _pair_idx(prog, prog.start + i, prog.start + j)
        if x[t] >= prog.x_ub[t]:
            c[i : j + 1] -= 1.0  # can't cover again; stop revisiting
            continue
        x[t] += 1.0
        c[i : j + 1] -= 1.0
    return x


def half_ceil(x: float, eps: float = 1e-6) -> float:
    """Round a bound up to the next multiple of 0.5."""
    import math

    return math.ceil((x - eps) * 2.0) / 2.0


def eps_quantum(prog: BfbProgram) -> float:
    """Lattice spacing of achievable epsilon sums: 0.5 when every
    residual target AND every residual coefficient is a half-integer
    (row values A·x are then half-integer multiples for integer x, so
    each |row − c| and their sum land on the 0.5 lattice); 0.0
    otherwise — fractional (noise-derived) targets put epsilon
    off-lattice, and a future builder with other fractional
    coefficients would too: rounding the LP bound up would then be
    UNSOUND (an incumbent could pass the rounded bound while a strictly
    better integer point exists below it). The coefficient check is an
    invariant guard: every current builder emits {0.5, 1, 2} entries,
    but certification soundness must not silently depend on that."""
    q = getattr(prog, "_eps_quantum_cache", None)
    if q is not None:
        return q
    c = np.concatenate([prog.c_seg, prog.c_fbi])
    q = 0.0
    if np.all(np.abs(c * 2.0 - np.round(c * 2.0)) < 1e-9):
        A = np.concatenate([prog.A_seg, prog.A_fbi], axis=0)
        if np.all(np.abs(A * 2.0 - np.round(A * 2.0)) < 1e-9):
            # coupling rows (targets 0, coefficients +-1) are always on
            # the lattice, so they never demote the quantum
            q = 0.5
    # cache on the (frozen-shape) program object: the A scan is O(rows*V)
    # and certification asks repeatedly during LNS screening
    object.__setattr__(prog, "_eps_quantum_cache", q)
    return q


def certified_bound(prog: BfbProgram, lb: float) -> float:
    """The sharpest sound optimality threshold from an LP bound: the
    bound rounded up to the epsilon lattice when one exists, the raw
    bound otherwise."""
    return half_ceil(lb) if eps_quantum(prog) > 0.0 else lb


def lp_relaxation(prog: BfbProgram):
    """Solve the LP relaxation; returns (bound, x_fractional) or
    (None, None)."""
    res = _lp_solve(prog)
    if res is None or not res.success:
        return None, None
    return float(res.fun), res.x[: prog.num_vars]


def lp_lower_bound(prog: BfbProgram) -> Optional[float]:
    bound, _ = lp_relaxation(prog)
    return bound


def _lp_solve(prog: BfbProgram):
    """LP-relaxation lower bound on the integer epsilon sum (host-side;
    sparse block assembly so large programs stay fast). None if scipy
    is unavailable or the LP fails."""
    try:
        from scipy.optimize import linprog
        from scipy.sparse import csr_matrix, eye, hstack, vstack
    except Exception:  # pragma: no cover
        return None
    V = prog.num_vars
    A_dense = np.concatenate([prog.A_seg, prog.A_fbi], axis=0)
    c_res = np.concatenate(
        [prog.c_seg, prog.c_fbi, np.zeros(prog.num_coupling)]
    )
    A_sp = csr_matrix(A_dense)
    if prog.num_coupling:
        # coupling rows assembled sparsely (2 nonzeros each): the dense
        # materialization is gigabytes at single-cell scale
        from scipy.sparse import coo_matrix

        P = prog.num_coupling
        r = np.arange(P)
        coup = coo_matrix(
            (
                np.concatenate([np.ones(P), -np.ones(P)]),
                (
                    np.concatenate([r, r]),
                    np.concatenate(
                        [prog.coupling[:, 0], prog.coupling[:, 1]]
                    ),
                ),
            ),
            shape=(P, V),
        ).tocsr()
        A_sp = vstack([A_sp, coup], format="csr")
    E = A_sp.shape[0]
    c = np.zeros(V + E)
    c[V:] = 1.0
    I = eye(E, format="csr")
    blocks = [hstack([-A_sp, -I]), hstack([A_sp, -I])]
    b_parts = [-c_res, c_res]
    if prog.G.shape[0]:
        G_sp = csr_matrix(prog.G)
        Z = csr_matrix((1, E))
        fin_ub = np.isfinite(prog.g_ub)
        if fin_ub.any():
            blocks.append(hstack([G_sp[fin_ub], csr_matrix((int(fin_ub.sum()), E))]))
            b_parts.append(prog.g_ub[fin_ub])
        fin_lb = np.isfinite(prog.g_lb)
        if fin_lb.any():
            blocks.append(hstack([-G_sp[fin_lb], csr_matrix((int(fin_lb.sum()), E))]))
            b_parts.append(-prog.g_lb[fin_lb])
        del Z
    A_ub = vstack(blocks, format="csr")
    b_ub = np.concatenate(b_parts)
    bounds = [(0, ub) for ub in prog.x_ub] + [(0, None)] * E
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
    return res


def _seed_case(
    prog: BfbProgram, Vp: int, x_ub_np: np.ndarray, pop: int, seed: int
):
    """Full population seeding for one case: the fixed constructive
    seeds (zero / root pattern / top loop / greedy peel), the LP
    relaxation's roundings, and sparse random starts. Returns
    (X0 [pop, Vp] float32, lp_lower_bound-or-None). Shared by
    solve_device and solve_device_batch."""
    X0 = np.array(_seed_population(prog, Vp, x_ub_np, pop, seed))

    def place(slot: int, member: np.ndarray) -> None:
        xi = np.zeros(Vp, dtype=np.float32)
        xi[: prog.num_vars] = np.clip(member, 0, prog.x_ub)
        X0[slot] = xi

    # constructive seed: greedy loop/pattern peel of the CN profile
    if pop > 3:
        place(3, greedy_peel_seed(prog))
    # LP-rounding seeds: the relaxation is cheap on host and its
    # roundings cluster around the integer optimum
    lb, x_frac = lp_relaxation(prog)
    if x_frac is not None and pop > 5:
        place(4, np.round(x_frac))
        place(5, np.floor(x_frac))
        # a few randomized roundings populate the LP basin; the rest of
        # the population stays random for basin diversity
        rr = np.random.default_rng(seed + 1)
        frac = x_frac - np.floor(x_frac)
        for slot in range(6, min(pop, 10)):
            place(slot, np.floor(x_frac) + (rr.random(len(x_frac)) < frac))
    return X0, lb


import threading as _threading

# one entry per (start, end, num_vars): {"host": (...), "dev": {dev_id: (...)}}
# — host catalogue and its per-device uploads evict TOGETHER, so the
# ~4MB device arrays cannot outlive their host entry on long
# heterogeneous case streams
_MOVES_CACHE: dict = {}
_MOVES_LOCK = _threading.Lock()  # created at import: lazy init was racy
_MOVES_CACHE_MAX = 64


def _device_moves(prog: BfbProgram, move_key, device):
    """Move catalogues, cached host-side by (start, end, num_vars) and
    device-side per device id under the same entry. Suites of
    same-interval cases rebuild identical catalogues per case otherwise
    — the O(n^3) host build plus a ~4MB host->device transfer each.
    Thread-safe: batch callers run solve_device on thread pools."""
    with _MOVES_LOCK:
        entry = _MOVES_CACHE.get(move_key)
        if entry is None:
            mv_minus, mv_plus = slide_transfer_moves(prog)
            m3 = split_merge_moves(prog)
            entry = {"host": (mv_minus, mv_plus, m3), "dev": {}}
            _MOVES_CACHE[move_key] = entry
            while len(_MOVES_CACHE) > _MOVES_CACHE_MAX:
                # FIFO eviction of a whole entry (host + device uploads)
                _MOVES_CACHE.pop(next(iter(_MOVES_CACHE)))
        mv_minus, mv_plus, m3 = entry["host"]
        dev_id = None if device is None else device.id
        dev = entry["dev"].get(dev_id)
        if dev is None:
            if device is not None:
                moves = (
                    jax.device_put(jnp.asarray(mv_minus), device),
                    jax.device_put(jnp.asarray(mv_plus), device),
                )
                moves3 = tuple(jax.device_put(jnp.asarray(a), device) for a in m3)
            else:
                moves = (jnp.asarray(mv_minus), jnp.asarray(mv_plus))
                moves3 = tuple(jnp.asarray(a) for a in m3)
            dev = (moves, moves3)
            entry["dev"][dev_id] = dev
        moves, moves3 = dev
    return moves, moves3, (mv_minus, m3)


def solve_device(
    prog: BfbProgram,
    pop: Optional[int] = None,
    seed: int = 0,
    rounds: Optional[int] = None,
    max_sweeps: Optional[int] = None,
    certify: bool = True,
    device=None,
    polish: bool = True,
    lns_budget: Optional[float] = None,
) -> SolveResult:
    """`device` pins the search to one device (e.g. round-robin case
    dispatch across a host's local devices: searches on different
    devices run concurrently because jit dispatch is async).

    `polish` runs the LNS window re-solves (solver.lns) on the search
    incumbent when it falls short of the LP certificate — measured to
    recover the exact optimum on noisy S=32-64 suites where the raw
    search plateaus a few epsilon above it. `lns_budget` caps that
    polish's wall clock (None: lns_polish's default / env
    AMBIGRAM_LNS_BUDGET); batch callers divide one global budget across
    their cases so a suite of uncertifiable programs cannot balloon.

    Search budget defaults are env-overridable (AMBIGRAM_SEARCH_POP /
    _ROUNDS / _SWEEPS) so tests and constrained hosts can shrink them
    without plumbing arguments through the pipeline."""
    d = _dispatch_single(
        prog,
        pop=pop,
        seed=seed,
        rounds=rounds,
        max_sweeps=max_sweeps,
        certify=certify,
        device=device,
    )
    x = _block_and_account(d)[: prog.num_vars]
    return _finish_solution(
        prog,
        x,
        d["lb"],
        certify=certify,
        polish=polish,
        lns_budget=lns_budget,
        converged=bool(d["converged"][0]),
    )


def _dispatch_single(
    prog: BfbProgram,
    pop: Optional[int] = None,
    seed: int = 0,
    rounds: Optional[int] = None,
    max_sweeps: Optional[int] = None,
    certify: bool = True,
    device=None,
) -> dict:
    """Seed + launch ONE case's tiered search without blocking on the
    result (jit dispatch is async). Returns a pending dict for
    `_block_and_account`; `solve_device` is dispatch+block+finish, and
    `solve_device_batch` dispatches every group before blocking on any
    so host tails overlap later device passes (VERDICT r4 #3)."""
    import os

    from ambigram_tpu.utils.cache import enable_compilation_cache
    from ambigram_tpu.utils.profiling import GLOBAL

    enable_compilation_cache()  # bucket compiles amortize across processes
    if pop is None:
        pop = int(os.environ.get("AMBIGRAM_SEARCH_POP", 32))
    if rounds is None:
        rounds = int(os.environ.get("AMBIGRAM_SEARCH_ROUNDS", 6))
    if max_sweeps is None:
        max_sweeps = int(os.environ.get("AMBIGRAM_SEARCH_SWEEPS", 256))
    patience = int(os.environ.get("AMBIGRAM_SEARCH_PATIENCE", 2))
    with GLOBAL.phase("solve.tensors"):
        st = scoring_tensors(prog)
        if device is not None:
            st = jax.device_put(st, device)
    Vp = st.H.shape[1]
    move_key = (prog.start, prog.end, prog.num_vars)
    x_ub_np = np.zeros(Vp, dtype=np.float32)
    x_ub_np[: prog.num_vars] = prog.x_ub
    with GLOBAL.phase("solve.lp_bound"):
        X0, lb = _seed_case(prog, Vp, x_ub_np, pop, seed)
    key = jax.random.PRNGKey(seed)
    moves, moves3, (mv_minus, m3) = _device_moves(prog, move_key, device)
    if device is not None:
        X0j = jax.device_put(jnp.asarray(X0), device)
        key = jax.device_put(key, device)
    else:
        X0j = jnp.asarray(X0)
    target = certified_bound(prog, lb) if (certify and lb is not None) else 0.0
    with GLOBAL.phase("score"):
        best_x, best_s, sweeps, stagnant = _search(
            st,
            X0j,
            key,
            moves,
            moves3,
            rounds=rounds,
            max_sweeps=max_sweeps,
            target=max(float(target), 0.0),
            patience=patience,
        )
    return {
        "best_x": best_x,
        "best_s": best_s,
        "stagnant": stagnant,
        "targets": np.asarray([max(float(target), 0.0)]),
        "patience": patience,
        "sweeps": sweeps,
        "lb": lb,
        "pop": pop,
        "Vp": Vp,
        "M": mv_minus.shape[0],
        "M3": m3[0].shape[0],
        "G": 1,
    }


def _block_and_account(d: dict) -> np.ndarray:
    """Block on a pending dispatch's device arrays, record the real
    candidates-scored count (a delta sweep evaluates 2*Vp moves per
    member, a paired-move sweep M, a triple sweep M3), return best_x as
    a host array ([Vp] for single dispatches, [G, Vp] for batched).
    Also resolves the per-case `converged` flags (stagnation exit or
    target met — vs round-budget starvation) the polish stage reads."""
    from ambigram_tpu.utils.profiling import GLOBAL

    with GLOBAL.phase("score"):
        best = np.asarray(d["best_x"])  # blocks until the search is done
        n_d, n_m, n_3 = (int(v) for v in d["sweeps"])
        stagnant = np.atleast_1d(np.asarray(d["stagnant"]))
        best_s = np.atleast_1d(np.asarray(d["best_s"]))
    d["converged"] = (stagnant > d["patience"]) | (
        best_s <= np.asarray(d["targets"]) + 1e-6
    )
    GLOBAL.count(
        "candidates_scored",
        float(d["G"] * d["pop"])
        * (n_d * 2.0 * d["Vp"] + n_m * d["M"] + n_3 * d["M3"]),
    )
    GLOBAL.count("solve.device_calls")
    return best


def _finish_solution(
    prog: BfbProgram,
    x: np.ndarray,
    lb: Optional[float],
    certify: bool = True,
    polish: bool = True,
    lns_budget: Optional[float] = None,
    converged: bool = True,
) -> SolveResult:
    """Host-side tail shared by solve_device and solve_device_batch:
    measure the incumbent, polish when it falls short of the
    certificate, certify, wrap.

    `converged` is the search's own exit signal (stagnation/target vs
    round-budget starvation, `_search_impl`): a CONVERGED incumbent is
    already a local optimum of the full tiered neighborhood, so it gets
    only the cheap probe (escalating on improvement); a BUDGET-STARVED
    one skips the probe and goes straight to the full polish — quality
    there depends on it (the S=28 tiny-budget regression in
    tests/test_lns.py pins this contract)."""
    import os

    from ambigram_tpu.utils.profiling import GLOBAL

    x_int = np.round(x).astype(np.int64)
    eps_sum = float(prog.residual_objective(x_int.astype(np.float64)))
    violation = float(prog.hard_violation(x_int.astype(np.float64)))
    tgt = certified_bound(prog, lb) if lb is not None else None
    if polish and (
        violation > 0.0
        or (eps_sum > 0.0 and (tgt is None or eps_sum > tgt + 1e-6))
    ):
        from ambigram_tpu.solver.lns import lns_polish

        with GLOBAL.phase("solve.lns"):
            # probe-then-escalate: a converged triple-move search
            # usually lands ON the integer optimum but the LP bound is
            # too weak to certify it, so a full LNS would spend
            # ~10 s/case proving no-improvement. Probe one tight
            # neighborhood first; only an actual improvement (evidence
            # the search plateaued short), a hard violation, or a
            # budget-starved search buys the full sweep.
            if violation > 0.0 or not converged:
                x_p, eps_p, vio_p = lns_polish(
                    prog, x_int, target=tgt, time_budget=lns_budget
                )
            else:
                import time as _time

                t0 = _time.perf_counter()
                full = (
                    lns_budget
                    if lns_budget is not None
                    else float(os.environ.get("AMBIGRAM_LNS_BUDGET", 45.0))
                )
                x_p, eps_p, vio_p = lns_polish(
                    prog,
                    x_int,
                    target=tgt,
                    time_budget=min(6.0, full),
                    probe=True,
                )
                left = full - (_time.perf_counter() - t0)
                if (vio_p, eps_p) < (violation, eps_sum) and left > 1.0 and (
                    tgt is None or eps_p > tgt + 1e-6
                ):
                    # escalate from the ORIGINAL incumbent, not the
                    # probe's point: the probe's budget-starved endpoint
                    # MILP can move the incumbent into a worse basin
                    # whose endpoint neighborhood no longer contains the
                    # optimum (measured: S=28 seed 11 lands 0.011 above
                    # it). The probe's result still competes below.
                    x_f, eps_f, vio_f = lns_polish(
                        prog, x_int, target=tgt, time_budget=left
                    )
                    if (vio_f, eps_f) < (vio_p, eps_p):
                        x_p, eps_p, vio_p = x_f, eps_f, vio_f
        if (vio_p, eps_p) < (violation, eps_sum):
            x_int, eps_sum, violation = x_p, eps_p, vio_p
    status = "heuristic"
    if violation == 0.0 and certify:
        # eps == 0 is its own certificate (the objective is nonnegative)
        if eps_sum == 0.0:
            status = "optimal"
        # otherwise the integer optimum is a half-integer >= the LP bound
        elif lb is not None and eps_sum <= certified_bound(prog, lb) + 1e-6:
            status = "optimal"
    elif violation > 0:
        status = "error"
    return SolveResult(
        x=x_int,
        epsilon_sum=eps_sum,
        objective=eps_sum - prog.bias,
        status=status,
    )


def solve_device_batch(
    progs,
    seed: int = 0,
    pop: Optional[int] = None,
    rounds: Optional[int] = None,
    max_sweeps: Optional[int] = None,
    certify: bool = True,
    device=None,
    polish: bool = True,
    lns_budget: Optional[float] = None,
    post_workers: int = 4,
):
    """Solve a list of fitting programs with the FULL tiered search in
    as few device programs as possible: programs sharing one
    (start, end, num_vars) interval and one padded tensor shape are
    case-stacked (parallel.mesh.stack_cases) and searched by
    `_batch_search` in ONE jit call — one compile, one transfer, and
    G*pop-row matmuls instead of G searches queuing on one chip (the
    measured failure mode of the threaded per-case batch:
    thread-summed `score` time ~4x the per-case cost). Groups are
    padded to power-of-two sizes (repeating the last program) so a
    stream of batches reuses a handful of compiled shapes.

    Two-phase pipeline (VERDICT r4 #3): phase 1 dispatches EVERY
    group's device pass asynchronously (largest first — singleton
    groups join via `_dispatch_single`), so the device queue is full
    before any host tail starts; phase 2 blocks on each group in
    dispatch order and runs its per-case probe/escalate LNS polish on a
    shared thread pool WHILE later groups still run on the chip.
    Host-side seeding (LP relaxations, GIL-released in HiGHS) threads
    within each group's dispatch. Returns [SolveResult] aligned with
    `progs`."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ambigram_tpu.parallel.mesh import stack_cases
    from ambigram_tpu.utils.cache import enable_compilation_cache
    from ambigram_tpu.utils.profiling import GLOBAL

    enable_compilation_cache()
    if pop is None:
        pop = int(os.environ.get("AMBIGRAM_SEARCH_POP", 32))
    if rounds is None:
        rounds = int(os.environ.get("AMBIGRAM_SEARCH_ROUNDS", 6))
    if max_sweeps is None:
        max_sweeps = int(os.environ.get("AMBIGRAM_SEARCH_SWEEPS", 256))
    patience = int(os.environ.get("AMBIGRAM_SEARCH_PATIENCE", 2))

    groups: dict = {}
    for i, prog in enumerate(progs):
        groups.setdefault((prog.start, prog.end, prog.num_vars), []).append(i)

    # ---- phase 1: DISPATCH every group's device pass before blocking
    # on any result (VERDICT r4 #3). jit dispatch is async, so group
    # k+1's search enters the device queue while group k's is still
    # running — and phase 2's host tails (LNS probes, certificates)
    # then overlap the remaining device passes instead of idling the
    # chip between groups. Larger groups first: their searches run
    # longest, so their tails start earliest.
    def _dispatch_group(key, idxs) -> dict:
        group = [progs[i] for i in idxs]
        G = len(group)
        # pad the group to a power of two (repeat the last program) so
        # varying batch sizes reuse a handful of compiled shapes
        Gp = 1
        while Gp < G:
            Gp *= 2
        padded = group + [group[-1]] * (Gp - G)
        with GLOBAL.phase("solve.tensors"):
            # int8-only transfer + on-device f32 expansion (stack_cases)
            st = stack_cases(padded, device=device)
        Vp = st.H.shape[-1]

        # per-case seeding (LP relaxations dominate; they release the
        # GIL inside HiGHS, so a small pool overlaps them)
        def _seed_one(k):
            prog = padded[k]
            x_ub_np = np.zeros(Vp, dtype=np.float32)
            x_ub_np[: prog.num_vars] = prog.x_ub
            return _seed_case(prog, Vp, x_ub_np, pop, seed + idxs[min(k, G - 1)])

        with GLOBAL.phase("solve.lp_bound"):
            with ThreadPoolExecutor(max_workers=post_workers) as pool:
                seeded = list(pool.map(_seed_one, range(Gp)))
        X0 = np.stack([s[0] for s in seeded])  # [Gp, pop, Vp]
        lbs = [s[1] for s in seeded]
        targets = np.asarray(
            [
                max(float(certified_bound(p, lb)), 0.0)
                if (certify and lb is not None)
                else 0.0
                for p, lb in zip(padded, lbs)
            ],
            dtype=np.float32,
        )
        keys = jnp.stack([jax.random.PRNGKey(seed + k) for k in range(Gp)])
        moves, moves3, (mv_minus, m3) = _device_moves(padded[0], key, device)
        X0j = jnp.asarray(X0)
        targets_j = jnp.asarray(targets)
        if device is not None:
            X0j = jax.device_put(X0j, device)
            targets_j = jax.device_put(targets_j, device)
            keys = jax.device_put(keys, device)
        with GLOBAL.phase("score"):
            best_x, best_s, sweeps, stagnant = _batch_search(
                st,
                X0j,
                keys,
                moves,
                moves3,
                rounds=rounds,
                max_sweeps=max_sweeps,
                targets=targets_j,
                patience=patience,
            )
        return {
            "idxs": idxs,
            "lbs": lbs,
            "best_x": best_x,
            "best_s": best_s,
            "stagnant": stagnant,
            "targets": targets,
            "patience": patience,
            "sweeps": sweeps,
            "pop": pop,
            "Vp": Vp,
            "M": mv_minus.shape[0],
            "M3": m3[0].shape[0],
            "G": Gp,
        }

    def _dispatch_one(key, idxs) -> dict:
        if len(idxs) == 1:
            i = idxs[0]
            d = _dispatch_single(
                progs[i],
                pop=pop,
                seed=seed + i,
                rounds=rounds,
                max_sweeps=max_sweeps,
                certify=certify,
                device=device,
            )
            d["idxs"] = idxs
            d["lbs"] = [d["lb"]]
            return d
        return _dispatch_group(key, idxs)

    ordered = sorted(groups.items(), key=lambda kv: -len(kv[1]) * kv[0][2])
    # in-flight window: each dispatched group keeps its stacked tensors
    # (f32 H alone is ~300MB for an 8-case S=48 group) and seed pools
    # alive on device until phase 2 drains it — a long heterogeneous
    # stream dispatched all at once could exhaust HBM, so keep a few
    # groups ahead of the drain (enough to hide every host tail behind
    # device work) and dispatch the rest as earlier groups retire
    max_inflight = 4
    results: list = [None] * len(progs)
    with ThreadPoolExecutor(max_workers=post_workers) as pool:
        futures = []
        pending: list = []
        next_up = 0
        while next_up < len(ordered) or pending:
            while next_up < len(ordered) and len(pending) < max_inflight:
                pending.append(_dispatch_one(*ordered[next_up]))
                next_up += 1
            d = pending.pop(0)  # oldest: furthest along on device
            best = _block_and_account(d)
            if best.ndim == 1:
                best = best[None, :]

            def _finish_one(i, x, lb, conv):
                return i, _finish_solution(
                    progs[i],
                    x,
                    lb,
                    certify=certify,
                    polish=polish,
                    lns_budget=lns_budget,
                    converged=conv,
                )

            for k, i in enumerate(d["idxs"]):
                futures.append(
                    pool.submit(
                        _finish_one,
                        i,
                        best[k, : progs[i].num_vars],
                        d["lbs"][k],
                        bool(d["converged"][k]),
                    )
                )
        for fut in futures:
            i, res = fut.result()
            results[i] = res
    return results
