"""Multi-device sharding of the BFB engine.

The reference is a single-threaded process (SURVEY.md section 2d); this
engine shards two independent axes over a device mesh:

- "case":  independent LH cases / chromosome subproblems (data
           parallelism — each case's tensors and candidate pool live on
           its own mesh slice);
- "model": the residual-row dimension of the scoring matmul (the
           tensor-parallel analog — each device scores a row shard and
           the per-candidate score is a psum over the axis).

Candidate-pool parallelism inside one case needs no collective at all
until the final argmin, which XLA lowers to an all-reduce.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ambigram_tpu.engine.ilp import BfbProgram
from ambigram_tpu.solver.score import ScoringTensors, row_values, scoring_tensors


def make_mesh(n_devices: Optional[int] = None, case_axis: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if case_axis is None:
        case_axis = n // 2 if (n % 2 == 0 and n > 1) else n
    model_axis = n // case_axis
    arr = np.array(devices).reshape(case_axis, model_axis)
    return Mesh(arr, ("case", "model"))


def stack_cases(
    progs: Sequence[BfbProgram], device=None
) -> ScoringTensors:
    """Stack several fitting programs into one leading-case-axis tensor
    set, padded to the max shape across cases.

    When every case's rows are int8-exact (they are for all current
    builders), ONLY the stacked int8 representation crosses the
    host→device link and the prescaled f32 tensors are expanded ON
    DEVICE (vmapped `_expand_f32`) — the same ~5× transfer cut the
    single-case `scoring_tensors` does, which keeps the stacked host
    build and transfer off a batch's critical path.
    `device` pins the transfer+expansion target."""
    from ambigram_tpu.solver.score import _expand_f32_cases

    pad_v = max(128, max(((p.num_vars + 127) // 128) * 128 for p in progs))
    # host tensors: restacking device arrays would cost a device->host
    # round trip per array per case. need_f32 False skips each case's
    # host f32 assembly (the f32 leaves are placeholders) — rebuilt
    # below only if some case is not int8-exact
    sts = [
        scoring_tensors(p, pad_vars=pad_v, device=False, need_f32=False)
        for p in progs
    ]
    if not all(st.int8_ok for st in sts):  # pragma: no cover - no
        # current builder emits fractional rows; full host f32 path
        sts = [scoring_tensors(p, pad_vars=pad_v, device=False) for p in progs]
    pad_r = max(st.H8.shape[0] for st in sts)

    def pad_rows(x, rows, fill=0.0, dtype=np.float32):
        out = np.full((rows,) + x.shape[1:], fill, dtype=dtype)
        out[: x.shape[0]] = np.asarray(x)
        return out

    big = np.float32(3.0e38)
    x_ub = np.stack([np.asarray(st.x_ub) for st in sts])
    H8 = np.stack([pad_rows(st.H8, pad_r, dtype=np.int8) for st in sts])
    lb_raw = np.stack([pad_rows(st.lb_raw, pad_r, -big) for st in sts])
    ub_raw = np.stack([pad_rows(st.ub_raw, pad_r, big) for st in sts])
    # padding rows must carry w=0 (the f32 expansion derives open
    # bounds and zero H rows from it)
    w = np.stack([pad_rows(st.w, pad_r, 0.0) for st in sts])
    int8_ok = all(st.int8_ok for st in sts)

    def put(a):
        aj = jnp.asarray(a)
        return jax.device_put(aj, device) if device is not None else aj

    if int8_ok:
        H8j = put(H8)
        lbr = put(lb_raw)
        ubr = put(ub_raw)
        wj = put(w)
        H, lb, ub = _expand_f32_cases(H8j, lbr, ubr, wj)
        return ScoringTensors(
            H=H,
            lb=lb,
            ub=ub,
            x_ub=put(x_ub),
            H8=H8j,
            lb_raw=lbr,
            ub_raw=ubr,
            w=wj,
            num_vars=pad_v,
            num_residual_rows=max(st.num_residual_rows for st in sts),
            int8_ok=True,
            x_ub_max=max(st.x_ub_max for st in sts),
        )
    H = np.stack([pad_rows(st.H, pad_r) for st in sts])
    lb = np.stack([pad_rows(st.lb, pad_r, -big) for st in sts])
    ub = np.stack([pad_rows(st.ub, pad_r, big) for st in sts])
    return ScoringTensors(
        H=put(H),
        lb=put(lb),
        ub=put(ub),
        x_ub=put(x_ub),
        H8=put(H8),
        lb_raw=put(lb_raw),
        ub_raw=put(ub_raw),
        w=put(w),
        num_vars=pad_v,
        num_residual_rows=max(st.num_residual_rows for st in sts),
        int8_ok=int8_ok,
        x_ub_max=max(st.x_ub_max for st in sts),
    )


def _local_score(H, lb, ub, w, x):
    """Score candidates against a row-shard of the unified program; the
    caller psums over the 'model' axis. `w` is the per-row hinge weight
    (all-ones for the prescaled f32 rows; 1/0.5/PENALTY for the int8
    representation, whose H rows are small integers)."""
    if H.dtype == jnp.int8:
        hx = jax.lax.dot_general(
            x.astype(jnp.int8),
            H,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)
    else:
        hx = row_values(x, H)
    over = jnp.maximum(hx - ub, 0.0)
    under = jnp.maximum(lb - hx, 0.0)
    return jnp.sum(w * (over + under), axis=-1)


def sharded_step(mesh: Mesh):
    """Build the jitted multi-case multi-device search step.

    Inputs (case-stacked):
      A [C, R, V], c [C, R], G [C, M, V], g_lb/g_ub [C, M],
      x_ub [C, V], X [C, B, V] candidate pools, moves [K, V].

    One step scores every member+move combination, psums row-shards
    over the "model" axis, and greedily applies each member's best
    move. Returns (X', scores'). "case" shards ride pure data
    parallelism; "model" shards meet in one psum per scoring call.
    """
    shard_map = jax.shard_map

    in_specs = (
        P("case", "model", None),  # H rows sharded over model axis
        P("case", "model"),
        P("case", "model"),
        P("case", "model"),  # w (row weights, sharded like rows)
        P("case", None),  # x_ub
        P("case", None, None),  # X
        P(None, None),  # moves (replicated)
    )
    out_specs = (P("case", None, None), P("case", None))

    def step(H, lb, ub, w, x_ub, X, moves):
        def per_case(H, lb, ub, w, x_ub, X):
            B, V = X.shape
            K = moves.shape[0]
            cand = jnp.clip(X[:, None, :] + moves[None, :, :], 0.0, x_ub)
            flat = cand.reshape(B * K, V)
            local = _local_score(H, lb, ub, w, flat)
            total = jax.lax.psum(local, "model").reshape(B, K)
            base_local = _local_score(H, lb, ub, w, X)
            base = jax.lax.psum(base_local, "model")
            idx = jnp.argmin(total, axis=1)
            best = jnp.take_along_axis(total, idx[:, None], axis=1)[:, 0]
            better = best < base
            chosen = jnp.clip(X + moves[idx], 0.0, x_ub)
            X_new = jnp.where(better[:, None], chosen, X)
            s_new = jnp.where(better, best, base)
            return X_new, s_new

        return jax.vmap(per_case)(H, lb, ub, w, x_ub, X)

    return jax.jit(
        shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )


def solve_cases_sharded(
    progs: Sequence[BfbProgram],
    mesh: Optional[Mesh] = None,
    pop: Optional[int] = None,
    steps: Optional[int] = None,
    rounds: Optional[int] = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Solve a batch of cases data-parallel across the mesh; returns the
    best integer candidate per case. Each round runs greedy best-move
    steps on device, then restarts every member from the per-case best
    with random kicks (the basin-hopping pattern of
    ambigram_tpu.solver.search, fanned over the case axis).

    Budgets are env-overridable via AMBIGRAM_SHARD_POP / _STEPS /
    _ROUNDS so tests and constrained hosts can shrink the stacked pass
    without plumbing arguments. The knobs are deliberately separate
    from solve_device's AMBIGRAM_SEARCH_* ones: a "step" here is one
    greedy best-move application (48 by default), not a full descent
    sweep (256 by default there) — sharing names would silently scale
    one when tuning the other."""
    import os

    from ambigram_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # stacked-pass compiles amortize across processes
    if pop is None:
        pop = int(os.environ.get("AMBIGRAM_SHARD_POP", 32))
    if steps is None:
        steps = int(os.environ.get("AMBIGRAM_SHARD_STEPS", 48))
    if rounds is None:
        rounds = int(os.environ.get("AMBIGRAM_SHARD_ROUNDS", 4))
    if mesh is None:
        mesh = make_mesh()
    case_dim = mesh.devices.shape[0]
    C = len(progs)
    Cp = ((C + case_dim - 1) // case_dim) * case_dim
    padded = list(progs) + [progs[-1]] * (Cp - C)
    st = stack_cases(padded)
    V = st.H.shape[-1]
    # move set: +-1 on each variable (padded vars have x_ub 0 so clipping
    # neutralizes them), plus the null move
    eye = np.eye(V, dtype=np.float32)
    moves = np.concatenate([np.zeros((1, V), np.float32), eye, -eye], axis=0)
    rng = np.random.default_rng(seed)
    x_ub = np.asarray(st.x_ub)
    # diverse seeds: member 0 zero, rest sparse random loop starts
    X = np.zeros((Cp, pop, V), dtype=np.float32)
    T = len(progs[0].pairs) if progs else 0
    for ci in range(Cp):
        for b in range(1, pop):
            k = rng.integers(1, 4)
            idx = rng.integers(0, max(T, 1), size=k)
            X[ci, b, T + idx] = rng.integers(1, 3, size=k)
        X[ci] = np.minimum(X[ci], x_ub[ci])
    step = sharded_step(mesh)
    # int8 path when every case's rows are small integers and the
    # candidate box fits int8 (exact; see solver/score.py)
    if st.use_int8:
        score_args = (st.H8, st.lb_raw, st.ub_raw, st.w)
    else:
        score_args = (st.H, st.lb, st.ub, jnp.ones_like(st.lb))
    moves_j = jnp.asarray(moves)
    best_x = np.zeros((Cp, V), dtype=np.float32)
    best_s = np.full(Cp, np.inf)
    Xj = jnp.asarray(X)
    for r in range(rounds):
        scores = None
        for _ in range(steps):
            Xj, scores = step(*score_args, st.x_ub, Xj, moves_j)
        Xn = np.asarray(Xj)
        Sn = np.asarray(scores)
        for ci in range(Cp):
            b = int(np.argmin(Sn[ci]))
            if Sn[ci, b] < best_s[ci]:
                best_s[ci] = Sn[ci, b]
                best_x[ci] = Xn[ci, b]
        if r + 1 < rounds:
            # kick: restart members from the per-case best, bumping only
            # real (unpadded) variables
            kick = np.zeros((Cp, pop, V), dtype=np.float32)
            for ci in range(Cp):
                nv = padded[ci].num_vars
                for b in range(1, pop):
                    k = int(rng.integers(2, 6))
                    idx = rng.integers(0, nv, size=k)
                    kick[ci, b, idx] += rng.choice([-2, -1, 1, 2], size=k)
            Xn = np.clip(best_x[:, None, :] + kick, 0.0, x_ub[:, None, :])
            Xj = jnp.asarray(Xn)
    out = []
    for i in range(C):
        out.append(np.round(best_x[i, : progs[i].num_vars]).astype(np.int64))
    return out
