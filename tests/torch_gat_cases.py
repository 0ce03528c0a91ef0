"""K5's degenerate test inputs, shared by the CPU tests
(``tests/test_torch_gat_edge.py``) and the card tests
(``tests/test_torch_cuda.py``).  numpy and torch only: the card tests
import neither JAX nor the reference package."""
import numpy as np
import torch

# Rows of the degenerate cases.
NO_VALID, LEADING, NAN_ROW, INF_ROW = 0, 3, 8, 9


def edge_case(kind, deg, rows=64, ncols=40, feat=8, seed=None):
    """K5's inputs: random ids over an (ncols + 1)-row table whose last row
    is the zero sentinel, 70% of the real ids valid.  Rows 0-2 have no
    valid slot and rows 3-5 none among their first 40 slots (all kinds);
    ``nan_score`` puts a NaN score in the table at a valid slot of row 8,
    ``inf_z`` a z row of +Inf, -Inf and NaN behind an invalid slot of row
    9 after its first valid one (its only slot, then invalid, if deg is
    1); ``padded`` gives each row a random degree and points its later
    slots at the sentinel, as the main path's ELLs do."""
    rng = np.random.default_rng(1000 + deg if seed is None else seed)
    nbr = rng.integers(0, ncols + 1, size=(rows, deg)).astype(np.int32)
    if kind == "padded":
        real = rng.integers(0, deg + 1, size=(rows, 1))
        nbr[np.arange(deg)[None, :] >= real] = ncols
    valid = (rng.random((rows, deg)) > 0.3) & (nbr < ncols)
    valid[NO_VALID:NO_VALID + 3] = False
    valid[LEADING:LEADING + 3, :40] = False
    s_dst = rng.normal(size=(rows,)).astype(np.float32)
    s_src = rng.normal(size=(ncols + 1,)).astype(np.float32)
    z = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    s_src[-1], z[-1] = 0, 0
    if deg and kind == "nan_score":
        k = deg // 2
        nbr[NAN_ROW, k], valid[NAN_ROW, k] = 5, True
        s_src[5] = np.nan
    if deg and kind == "inf_z":
        k = min(1, deg - 1)
        nbr[INF_ROW, 0], valid[INF_ROW, 0] = 0, True
        nbr[INF_ROW, k], valid[INF_ROW, k] = 7, False
        z[7] = np.inf
        if feat > 2:
            z[7, 1], z[7, 2] = -np.inf, np.nan
    return nbr, valid, s_dst, s_src, z


def bits(t):
    """A float32 tensor's bits, every NaN as the one canonical NaN, so
    that ``torch.equal`` compares NaN positions too."""
    return torch.where(t.isnan(), float("nan"), t).view(torch.int32)
