"""Batched candidate scoring — the hot kernel of the engine.

A candidate BFB structure is an integer vector x = [patterns | loops].
Its score is the ILP objective the reference ships to cbc
(LGM.cpp:4397-4752), with epsilons eliminated analytically:

    score(x) = sum |A x - c|  +  PENALTY * violation(G x, g_lb, g_ub)

Since |r - c| = max(r - c, 0) + max(c - r, 0), a residual row is just a
hard row with lb = ub = c, so the whole program unifies into one
matrix H = [A; PENALTY*G] with bounds and score = sum of two hinges —
a single matmul plus a fused elementwise reduction.

Arrays are padded to 128-variable / 256-row multiples so programs of
similar size share one compiled shape. The f32 path is exact: entries
are small integers (or 1024-scaled ones) and every score is a multiple
of 0.5, which f32 holds exactly below 2^23 (above that only heavily
infeasible candidates lie). That needs true f32 products: `row_values`
pins them, so a GPU cannot round the operands to TF32, whose 10-bit
mantissa holds integers only up to 2048 while candidate loop counts
reach the sum of copy numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ambigram_tpu.engine.ilp import BfbProgram

PENALTY = 1024.0  # dominates any achievable residual for in-range programs
_BIG = 3.0e38  # finite stand-in for +-inf bounds


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def row_values(x: jnp.ndarray, H: jnp.ndarray) -> jnp.ndarray:
    """hx = x @ H.T over the last axis (leading axes batch), in true
    f32: `Precision.HIGHEST` keeps a GPU from running the product in
    TF32, which would round candidate entries above 2048 and break the
    exactness every score comparison relies on."""
    return jnp.matmul(
        x,
        jnp.swapaxes(H, -1, -2),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class ScoringTensors:
    """Padded device-ready tensors for one fitting program.

    Two equivalent representations are carried:

    f32 (always valid):
      H  [Rows, Vp]  unified rows: residual rows of A (lb = ub = c) then
                     hard rows of G prescaled by PENALTY
      lb [Rows], ub [Rows]  row bounds (prescaled for the G rows)

    int8 (integer-matmul path; used when `int8_ok` and the candidate
    box fits in int8):
      H8 [Rows, Vp]  the same rows with FBI rows doubled so every entry
                     is a small integer; penalty NOT prescaled
      lb_raw/ub_raw  matching unscaled bounds (FBI rows doubled)
      w  [Rows]      per-row hinge weights (1 / 0.5 / PENALTY) applied
                     AFTER the hinge — mathematically identical to the
                     prescaled f32 form (exact in f64, verified in tests)

    x_ub [Vp]      variable upper bounds (0 on padding lanes)
    """

    H: jnp.ndarray
    lb: jnp.ndarray
    ub: jnp.ndarray
    x_ub: jnp.ndarray
    H8: jnp.ndarray
    lb_raw: jnp.ndarray
    ub_raw: jnp.ndarray
    w: jnp.ndarray
    num_vars: int
    num_residual_rows: int
    int8_ok: bool
    x_ub_max: float

    def tree_flatten(self):
        return (
            (self.H, self.lb, self.ub, self.x_ub, self.H8, self.lb_raw, self.ub_raw, self.w),
            (self.num_vars, self.num_residual_rows, self.int8_ok, self.x_ub_max),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            *children,
            num_vars=aux[0],
            num_residual_rows=aux[1],
            int8_ok=aux[2],
            x_ub_max=aux[3],
        )

    @property
    def use_int8(self) -> bool:
        """int8 scoring is exact only while candidates stay within int8;
        the search clips to x_ub, so that bound decides."""
        return self.int8_ok and self.x_ub_max <= 127.0


@jax.jit
def _expand_f32(H8, lb_raw, ub_raw, w):
    """Reconstruct the prescaled f32 representation from the int8 one,
    on device: H = w ⊙ H8 row-wise (exact — w ∈ {1, 0.5, PENALTY} and
    entries are small ints), bounds = w * raw bounds clamped to ±BIG
    (w * ±BIG overflows f32 to ±inf on PENALTY rows; the clamp restores
    the finite host-side convention). Padding rows have w = 0 and zero
    H rows, so their hinge contribution is 0 either way."""
    H = w[:, None] * H8.astype(jnp.float32)
    lb = jnp.maximum(w * lb_raw, -_BIG)
    ub = jnp.minimum(w * ub_raw, _BIG)
    # padding rows (w == 0): keep the host convention of open bounds so
    # any hx lands inside [-BIG, BIG] with zero hinge
    pad = w == 0.0
    lb = jnp.where(pad, -_BIG, lb)
    ub = jnp.where(pad, _BIG, ub)
    return H, lb, ub


# case-stacked expansion (parallel.mesh.stack_cases): module-level so
# the jit trace cache persists — a jit(vmap(...)) built per call is a
# fresh function object and retraces every time
_expand_f32_cases = jax.jit(jax.vmap(_expand_f32))


def scoring_tensors(
    prog: BfbProgram,
    pad_vars: Optional[int] = None,
    pad_rows: Optional[int] = None,
    device: bool = True,
    need_f32: bool = True,
) -> ScoringTensors:
    """device=False keeps the tensors as host numpy arrays — for callers
    that restack/pad them (parallel.mesh.stack_cases).
    need_f32=False additionally skips the HOST f32 assembly when the
    int8 representation is exact (stack_cases expands f32 on device, so
    the per-case host f32 build — ~70MB of f64 temporaries per S=48
    case — is pure waste there); the returned f32 leaves are 1-row
    placeholders in that case.

    The int8 representation is assembled first; when it is exact
    (int8_ok — every current builder emits {±1, ±2, 0.5·2} entries) and
    the tensors are going to a device, only the int8 matrix crosses the
    host→device link and the f32 representation is expanded on device
    (`_expand_f32`): ~5× fewer bytes to transfer, and the host never
    materializes the f64/f32 dense intermediates."""
    V = prog.num_vars
    Vp = pad_vars if pad_vars is not None else _round_up(max(V, 128), 128)
    # residual rows: [seg | fbi | coupling] — coupling pairs (the SC
    # evolution terms) materialize here as +-1 int8 rows with target 0
    R0 = prog.A_seg.shape[0] + prog.A_fbi.shape[0]
    P = prog.num_coupling
    R = R0 + P
    M = prog.G.shape[0]
    rows = R + M
    # bucketing so instances of similar size share one compiled search
    # program; 256 wastes at most ~7% of rows on mid-size programs
    Rp = pad_rows if pad_rows is not None else _round_up(max(rows, 256), 256)
    x_ub = np.zeros(Vp, dtype=np.float32)
    x_ub[:V] = prog.x_ub

    # int8 representation: double the FBI rows so the 0.5 coefficients
    # become integers, keep G unscaled, weight the hinges instead;
    # coupling rows are +-1 already (weight 1, target 0)
    n_seg = prog.A_seg.shape[0]
    A_int = np.concatenate([prog.A_seg, 2.0 * prog.A_fbi], axis=0)
    c_int = np.concatenate([prog.c_seg, 2.0 * prog.c_fbi])
    H8 = np.zeros((Rp, Vp), dtype=np.int8)
    a8 = A_int.astype(np.int8)
    int8_ok = bool(np.array_equal(a8.astype(np.float64), A_int))
    del A_int
    H8[:R0, :V] = a8
    if P:
        rr = R0 + np.arange(P)
        H8[rr, prog.coupling[:, 0]] = 1
        H8[rr, prog.coupling[:, 1]] = -1
    lb_raw = np.full(Rp, -_BIG, dtype=np.float32)
    ub_raw = np.full(Rp, _BIG, dtype=np.float32)
    lb_raw[:R0] = c_int
    ub_raw[:R0] = c_int
    lb_raw[R0:R] = 0.0
    ub_raw[R0:R] = 0.0
    w = np.zeros(Rp, dtype=np.float32)
    w[:n_seg] = 1.0
    w[n_seg:R0] = 0.5
    w[R0:R] = 1.0
    if M:
        if prog.G.dtype == np.int8:
            # already the exact storage dtype (every current builder):
            # skip the 70MB-of-f64 verification round trip per case
            g8 = prog.G
        else:
            g8 = prog.G.astype(np.int8)
            int8_ok = int8_ok and bool(
                np.array_equal(g8.astype(np.float64), prog.G)
            )
        H8[R : R + M, :V] = g8
        lb_raw[R : R + M] = np.maximum(prog.g_lb, -_BIG)
        ub_raw[R : R + M] = np.minimum(prog.g_ub, _BIG)
        w[R : R + M] = PENALTY

    if device and int8_ok:
        H8j = jnp.asarray(H8)
        lbr = jnp.asarray(lb_raw)
        ubr = jnp.asarray(ub_raw)
        wj = jnp.asarray(w)
        Hj, lbj, ubj = _expand_f32(H8j, lbr, ubr, wj)
        return ScoringTensors(
            H=Hj,
            lb=lbj,
            ub=ubj,
            x_ub=jnp.asarray(x_ub),
            H8=H8j,
            lb_raw=lbr,
            ub_raw=ubr,
            w=wj,
            num_vars=V,
            num_residual_rows=R,
            int8_ok=int8_ok,
            x_ub_max=float(prog.x_ub.max()) if V else 0.0,
        )

    if not need_f32 and int8_ok:
        # host-restack caller (stack_cases) expands f32 on device:
        # return 1-row placeholders instead of the host f32 build
        conv = jnp.asarray if device else np.asarray
        return ScoringTensors(
            H=conv(np.zeros((1, Vp), dtype=np.float32)),
            lb=conv(np.zeros(1, dtype=np.float32)),
            ub=conv(np.zeros(1, dtype=np.float32)),
            x_ub=conv(x_ub),
            H8=conv(H8),
            lb_raw=conv(lb_raw),
            ub_raw=conv(ub_raw),
            w=conv(w),
            num_vars=V,
            num_residual_rows=R,
            int8_ok=int8_ok,
            x_ub_max=float(prog.x_ub.max()) if V else 0.0,
        )

    # host f32 assembly (fractional-coefficient programs, or callers
    # that restack the numpy arrays themselves)
    A_np = np.concatenate([prog.A_seg, prog.A_fbi], axis=0)
    c_np = np.concatenate([prog.c_seg, prog.c_fbi], axis=0)
    H = np.zeros((Rp, Vp), dtype=np.float32)
    lb = np.full(Rp, -_BIG, dtype=np.float32)
    ub = np.full(Rp, _BIG, dtype=np.float32)
    H[:R0, :V] = A_np
    lb[:R0] = c_np
    ub[:R0] = c_np
    if P:
        rr = R0 + np.arange(P)
        H[rr, prog.coupling[:, 0]] = 1.0
        H[rr, prog.coupling[:, 1]] = -1.0
        lb[R0:R] = 0.0
        ub[R0:R] = 0.0
    if M:
        H[R : R + M, :V] = PENALTY * prog.G
        lb[R : R + M] = np.maximum(PENALTY * prog.g_lb, -_BIG)
        ub[R : R + M] = np.minimum(PENALTY * prog.g_ub, _BIG)

    conv = jnp.asarray if device else np.asarray
    return ScoringTensors(
        H=conv(H),
        lb=conv(lb),
        ub=conv(ub),
        x_ub=conv(x_ub),
        H8=conv(H8),
        lb_raw=conv(lb_raw),
        ub_raw=conv(ub_raw),
        w=conv(w),
        num_vars=V,
        num_residual_rows=R,
        int8_ok=int8_ok,
        x_ub_max=float(prog.x_ub.max()) if V else 0.0,
    )


def score_batch(st: ScoringTensors, x: jnp.ndarray) -> jnp.ndarray:
    """Score candidates. x: [..., Vp] float32 (integer-valued, within
    [0, x_ub]). Returns residual + PENALTY * violation, shape [...].

    Dispatches to the int8 path (exact integer matmul with int32
    accumulation) when the program and candidate box permit; otherwise
    the pinned-f32 path. `use_int8` is static, so each program compiles
    one variant."""
    if st.use_int8:
        hx = jax.lax.dot_general(
            x.astype(jnp.int8),
            st.H8,
            dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)
        over = jnp.maximum(hx - st.ub_raw, 0.0)
        under = jnp.maximum(st.lb_raw - hx, 0.0)
        return jnp.sum(st.w * (over + under), axis=-1)
    hx = row_values(x, st.H)
    over = jnp.maximum(hx - st.ub, 0.0)
    under = jnp.maximum(st.lb - hx, 0.0)
    return jnp.sum(over, axis=-1) + jnp.sum(under, axis=-1)


score_batch_jit = jax.jit(score_batch)
