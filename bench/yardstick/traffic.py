"""Bytes that the solver's work must move, from shapes alone.

Kernel counts read each input once and write each output once.  The
whole-iteration count is the matrix once plus the textbook Jacobi-PCG
iteration's vectors once each; it does not depend on how the program fuses
its passes, so it reads the same work whatever implements it."""

#: inputs and outputs (n-vectors per lane) of each fused CG/BiCGStab body,
#: by the name the program counts its launches under
BODY_VECTORS = {
    "fused_cg_update": (5, 3),      # x, r, p, s, dinv -> x, r, z
    "fused_cg_direction": (4, 2),   # z, w, p, s -> p, s
    "fused_cg_halfstep": (4, 2),    # x, r, p, s -> x, r
    "fused_cheb_step": (3, 2),      # x, d, r -> d, x
    "fused_dots2": (2, 0),          # u, v
    "fused_bicg_p": (4, 2),         # r, p, v, dinv -> p, phat
    "fused_bicg_s": (3, 2),         # r, v, dinv -> s, shat
    "fused_bicg_tail": (6, 2),      # x, s, t, phat, shat, rhat -> x, r
}

#: vectors of one textbook Jacobi-PCG iteration, each counted once:
#: x, r, z, p, q = A p, and the inverse diagonal
PCG_VECTORS = 6

#: the 5-point operator as planes: centre, north, south, west, east
STENCIL_PLANES = 5


def body_bytes(name: str, n: int, lanes: int = 1, itemsize: int = 8) -> int:
    """One launch of a fused body over ``lanes`` lanes of length ``n``."""
    n_in, n_out = BODY_VECTORS[name]
    return (n_in + n_out) * n * lanes * itemsize


def stencil5_bytes(n: int, lanes: int = 1, itemsize: int = 8) -> int:
    """One 5-point product per lane: its 5 planes and x read, y written."""
    return (STENCIL_PLANES + 2) * n * lanes * itemsize


def operator_nnz(ng: int) -> int:
    """Nonzeros of the 5-point operator on an ng x ng grid with Dirichlet
    boundaries: every cell, and each interior face twice."""
    return 5 * ng * ng - 4 * ng


def matrix_bytes(layout: str, ng: int, itemsize: int = 8) -> int:
    """The operator read once: 5 planes for the stencil layout; CSR with
    int32 column indices and row pointers for a general sparse matrix."""
    n = ng * ng
    if layout == "stencil":
        return STENCIL_PLANES * n * itemsize
    if layout == "coo":
        return operator_nnz(ng) * (itemsize + 4) + (n + 1) * 4
    raise ValueError(f"unknown layout {layout!r}")


def pcg_iteration_bytes(layout: str, ng: int, itemsize: int = 8) -> int:
    """One Jacobi-PCG iteration of one lane: the matrix once and each of the
    textbook iteration's vectors once."""
    return matrix_bytes(layout, ng, itemsize) + PCG_VECTORS * ng * ng * itemsize


def roofline_share(nbytes: float, seconds: float,
                   bandwidth: float) -> float:
    """Per cent of the least time the bytes take at ``bandwidth`` over the
    time measured."""
    return 100.0 * nbytes / bandwidth / seconds
