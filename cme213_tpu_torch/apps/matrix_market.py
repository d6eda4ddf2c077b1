"""MatrixMarket → SpMV-scan problem instances (the readMM.py parity path).

The reference's dataset generators (``hw/hw_final/programming/aux/readMM.py``,
``aux/fileReadMM.py``) read SuiteSparse ``.mtx`` files with SciPy and emit
``a.txt``/``x.txt`` instances: ``a`` = the nonzero values, ``s`` = a random
sorted subset of indices (with 0/n sentinels), ``k`` = random gather indices,
``x`` = uniform(−1,1), ``N`` ∈ [5,100].  This module does the same with a
dependency-free coordinate-format parser, so real SuiteSparse matrices can be
fed to the engine when available.

Counterpart of ``cme213_tpu/apps/matrix_market.py`` (numpy only): the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import warnings

import numpy as np

from ..core.errors import data_error
from .spmv_scan import Problem


def read_matrix_market(path: str):
    """Minimal MatrixMarket coordinate parser, hardened at the boundary.

    Supports ``matrix coordinate (real|integer|pattern) (general|symmetric)``.
    Returns (rows, cols, values, shape) with 0-based indices, symmetric
    entries expanded.

    Every ingestion invariant is checked here — header/banner shape, the
    size line, entry count vs the declared nnz (truncated downloads), the
    per-entry column arity, 1-based index bounds, value finiteness — and a
    violation raises a structured :class:`core.errors.DataValidationError`
    (with its ``data-validation`` record) instead of shipping garbage
    into the SpMV engine, where a bad index would surface as a silent
    out-of-bounds gather clamp.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        header = f.readline().strip().lower().split()
        if header[:2] != ["%%matrixmarket", "matrix"]:
            raise data_error(path, "banner",
                             "not a MatrixMarket matrix file")
        if len(header) < 5:
            raise data_error(path, "banner",
                             f"truncated banner ({' '.join(header)!r})")
        if header[2] != "coordinate":
            raise data_error(path, "format",
                             f"only coordinate format supported, "
                             f"got {header[2]!r}")
        field, sym = header[3], header[4]
        if field not in ("real", "integer", "pattern"):
            raise data_error(path, "field", f"unsupported field {field!r}")
        if sym not in ("general", "symmetric"):
            raise data_error(path, "symmetry",
                             f"unsupported symmetry {sym!r}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        try:
            nr, nc, nnz = (int(v) for v in line.split())
        except ValueError as e:
            raise data_error(path, "size-line",
                             f"bad size line {line.strip()!r}: {e}") from e
        if nr <= 0 or nc <= 0 or nnz < 0:
            raise data_error(path, "size-line",
                             f"non-positive dims/count ({nr}, {nc}, {nnz})")
        try:
            with warnings.catch_warnings():
                # a file truncated to zero entries triggers np.loadtxt's
                # empty-input UserWarning; that case is data, not noise —
                # it flows into the entry-count DataValidationError below
                warnings.simplefilter("ignore", UserWarning)
                data = np.loadtxt(f, ndmin=2)
        except ValueError as e:
            raise data_error(path, "entries",
                             f"unparseable entry data: {e}") from e
    want_cols = 2 if field == "pattern" else 3
    if nnz == 0:
        data = data.reshape(0, want_cols)
    if data.shape[0] != nnz:
        raise data_error(path, "entry-count",
                         f"header declares {nnz} entries, file holds "
                         f"{data.shape[0]} (truncated or padded file)")
    if nnz and data.shape[1] < want_cols:
        raise data_error(path, "entry-arity",
                         f"{field} entries need {want_cols} columns, "
                         f"got {data.shape[1]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    if nnz and (not np.all(data[:, :2] == np.floor(data[:, :2]))):
        raise data_error(path, "index-integrality",
                         "fractional row/col index")
    if ((rows < 0) | (rows >= nr)).any() or ((cols < 0) | (cols >= nc)).any():
        raise data_error(path, "index-bounds",
                         f"row/col index outside 1..{nr} x 1..{nc}")
    if field == "pattern":
        vals = np.ones(rows.shape[0], dtype=np.float32)
    else:
        vals = data[:, 2].astype(np.float32)
        if not np.isfinite(vals).all():
            raise data_error(path, "value-finiteness",
                             "non-finite (nan/inf) matrix value")
    if sym == "symmetric":
        if ((rows < cols).any()):
            raise data_error(path, "symmetry",
                             "symmetric file stores an upper-triangle "
                             "entry (lower triangle expected)")
        off = rows != cols
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, vals[off]])
    return rows, cols, vals, (nr, nc)


def coo_to_csr(rows, cols, vals, shape):
    """(indptr, indices, data) in canonical CSR (row-major, columns sorted
    within each row) from validated COO triplets."""
    nr, _ = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(nr + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cols, vals


def validate_csr(indptr, indices, data, shape, source: str = "csr") -> None:
    """CSR structural invariants, raising structured
    :class:`DataValidationError` on the first violation: ``indptr`` is
    monotone non-decreasing with ``indptr[0] == 0`` and
    ``indptr[-1] == nnz``; column indices are in-bounds; values finite."""
    nr, nc = shape
    if indptr.shape[0] != nr + 1:
        raise data_error(source, "indptr-length",
                         f"len(indptr)={indptr.shape[0]}, rows+1={nr + 1}")
    if indptr[0] != 0:
        raise data_error(source, "indptr-origin",
                         f"indptr[0]={indptr[0]} != 0")
    if (np.diff(indptr) < 0).any():
        raise data_error(source, "indptr-monotone",
                         "indptr decreases (overlapping rows)")
    if indptr[-1] != indices.shape[0] or indices.shape[0] != data.shape[0]:
        raise data_error(source, "nnz-consistency",
                         f"indptr[-1]={indptr[-1]}, len(indices)="
                         f"{indices.shape[0]}, len(data)={data.shape[0]}")
    if indices.size and (((indices < 0) | (indices >= nc)).any()):
        raise data_error(source, "column-bounds",
                         f"column index outside 0..{nc - 1}")
    if not np.isfinite(data).all():
        raise data_error(source, "value-finiteness",
                         "non-finite (nan/inf) CSR value")


def csr_from_mtx(path: str):
    """Load ``path`` straight to validated canonical CSR:
    ``(indptr, indices, data, shape)``.  Both the COO-level ingestion
    checks (``read_matrix_market``) and the CSR structural invariants
    (``validate_csr``) have passed when this returns."""
    rows, cols, vals, shape = read_matrix_market(path)
    indptr, indices, data = coo_to_csr(rows, cols, vals, shape)
    validate_csr(indptr, indices, data, shape, source=path)
    return indptr, indices, data, shape


def gr_30_30_mtx() -> str:
    """Reconstruct SuiteSparse ``HB/gr_30_30`` as MatrixMarket text.

    The published problem is exactly defined: the nine-point star
    discretization of the Laplacian on a 30×30 grid (n = 900,
    nnz = 7744 expanded — 900 diagonal + 6844 king-graph adjacencies),
    symmetric.  The repository ships this *reconstruction* rather than
    the SuiteSparse download: the
    nonzero pattern is forced by the discretization and matches the
    SuiteSparse instance; values use the standard 9-point star
    coefficients (8 on the diagonal, −1 for the eight neighbours).
    Stored as symmetric/lower like the original HB-derived .mtx
    (4322 stored entries), which also exercises the reader's symmetric
    expansion path.
    """
    side = 30
    entries = []  # (row, col, value) 1-based, lower triangle
    for i in range(side):
        for j in range(side):
            r = i * side + j
            entries.append((r + 1, r + 1, 8.0))
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    if di == 0 and dj == 0:
                        continue
                    ni, nj = i + di, j + dj
                    if not (0 <= ni < side and 0 <= nj < side):
                        continue
                    c = ni * side + nj
                    if c < r:  # store lower triangle only
                        entries.append((r + 1, c + 1, -1.0))
    entries.sort(key=lambda e: (e[1], e[0]))  # column-major like HB files
    n = side * side
    lines = [
        "%%MatrixMarket matrix coordinate real symmetric",
        "% HB/gr_30_30 — nine-point star discretization on a 30x30 grid.",
        "% Reconstructed from the published problem definition: the",
        "% pattern is exactly the SuiteSparse instance's (n=900,",
        "% nnz=7744 expanded); values are the standard",
        "% 9-point star coefficients.",
        f"{n} {n} {len(entries)}",
    ]
    lines += [f"{r} {c} {v:.1f}" for r, c, v in entries]
    return "\n".join(lines) + "\n"


def gr_30_30_path() -> str:
    """Path of the shipped real-matrix instance (examples/gr_30_30.mtx)."""
    import os

    return os.path.join(os.path.dirname(__file__), "..", "..", "examples",
                        "gr_30_30.mtx")


def dense2_problem(iters: int | None = 10, seed: int = 0) -> Problem:
    """Reconstruct the suite's ``Williams/dense2`` instance.

    The published problem (named in ``aux/reference_spMVscan-released.cu:
    168-185``) is a literal dense 2000×2000 matrix stored in sparse
    format, so its nonzero pattern is fully determined: all 4,000,000
    entries, column-major in the MatrixMarket file the readMM.py pipeline
    consumed (``aux/readMM.py:16-73``).  As with the shipped gr_30_30
    reconstruction, the values are canonical (1.0) and the row is labeled
    a reconstruction.  Built
    in memory rather than via a .mtx detour — a 4M-line text file would
    add ~60 MB and a multi-second parse for zero extra information.

    The default iteration count is the suite table's published N=10 for
    dense2 (``paper/Final_Report_DongBang_Tsai.tex:236-251``), so the
    real row is directly comparable to the suite-shaped synthetic row.
    """
    vals = np.ones(2000 * 2000, dtype=np.float32)
    return _problem_from_values(vals, nr=2000, iters=iters, seed=seed)


def real_instance_specs():
    """Shipped/reconstructed *real* suite instances: a list of
    ``(name, source_label, problem_factory)``.

    The benchmark suite is defined over named SuiteSparse matrices; these
    are the ones whose published definitions pin them down well enough to
    rebuild offline (pattern exact, values canonical, labels say so).
    The rest of the 15-instance suite stays honestly synthetic.
    """
    import os

    specs = []
    mtx = gr_30_30_path()
    if os.path.exists(mtx):
        specs.append(("gr_30_30", "real (HB/gr_30_30, reconstructed)",
                      lambda: problem_from_mtx(mtx, iters=50, seed=0)))
    specs.append(("dense2", "real (Williams/dense2, reconstructed)",
                  lambda: dense2_problem(iters=10, seed=0)))
    return specs


def problem_from_mtx(path: str, iters: int | None = None,
                     seed: int = 0) -> Problem:
    """readMM.py construction: values → ``a``; random sorted row-index subset
    → ``s``; random ``k``; uniform(−1,1) ``x``; N ∈ [5,100]."""
    _, _, vals, (nr, _) = read_matrix_market(path)
    return _problem_from_values(vals, nr=nr, iters=iters, seed=seed)


def _problem_from_values(vals: np.ndarray, nr: int,
                         iters: int | None = None, seed: int = 0) -> Problem:
    rng = np.random.default_rng(seed)
    n = vals.shape[0]
    p_interior = min(max(nr - 1, 1), n - 1)
    interior = np.sort(rng.choice(np.arange(1, n), size=p_interior,
                                  replace=False))
    s = np.concatenate([[0], interior, [n]]).astype(np.int32)
    q = max(nr, 2)
    k = rng.integers(0, q, size=n, dtype=np.int32)
    x = rng.uniform(-1, 1, size=q).astype(np.float32)
    if iters is None:
        iters = int(rng.integers(5, 101))
    prob = Problem(vals.astype(np.float32), s, k, x, iters)
    prob.validate()
    return prob
