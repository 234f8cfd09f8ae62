"""What ``csrc/tile_gemv_trsv.cu`` decides from a tile's shape, mirrored in Python (numpy only).

The CPU tests (``test_torch_kernel_maps.py``) check these mirrors; the card's
tests (``test_torch_gpu.py``) hold the library's own answers to them.  The
constants are read from the source.

* The GEMV's maps: row-major tiles run (q, b) as chunks t = q * ceil(n / V) +
  b // V of V = 16 / itemsize columns, lane t % 32, accumulator b % V, in
  order of t; column-major tiles split the Q n columns into equal slices, one
  a warp, added in warp order.  :func:`gemv_rows_rendition` and
  :func:`gemv_cols_rendition` follow those orders in the operands' type.
* The solve's plan (cluster size, variant, shared memory) from (m, itemsize),
  its row ownership, and :func:`trsv_rendition`, the blocked solve in the
  kernel's order: inverted diagonal blocks padded with the identity, the
  updates of a block in the order of the chain, four partials a dot product.
"""

import re
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc" / "tile_gemv_trsv.cu"


def source_int(name: str) -> int:
    """The value of ``constexpr <int|size_t> name = <int>;`` in the source."""
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", SOURCE.read_text()).group(1))


GEMV_WARPS = source_int("kGemvThreads") // 32
BLOCK = source_int("kBlock")
TRSV_WARPS = source_int("kTrsvThreads") // 32
MAX_CLUSTER = source_int("kMaxCluster")
RING = source_int("kRing")
MAX_SMEM = source_int("kMaxSmem")
GEMV_VARIANTS = ("rows/scalar", "rows/vector", "cols/scalar", "cols/vector")


def vec(itemsize: int) -> int:
    """Elements of a 16-byte load."""
    return 16 // itemsize


# ---------------------------------------------------------------------------
# tile_gemv
# ---------------------------------------------------------------------------


def gemv_variant(ptr_a: int, ptr_x: int, m: int, n: int, sa, sx, itemsize: int) -> str:
    """The route and load width of a launch: its strides (elements) and its pointers' alignment."""
    v = vec(itemsize)
    whole = all(s % v == 0 for s in sa[:4]) and all(s % v == 0 for s in sx[:3])
    if sa[4] == 1 or sa[3] != 1:
        ok = sa[4] == 1 and sx[3] == 1 and n % v == 0 and ptr_a % 16 == 0 and ptr_x % 16 == 0 and whole
        return GEMV_VARIANTS[int(ok)]
    ok = m % v == 0 and ptr_a % 16 == 0 and all(s % v == 0 for s in (sa[0], sa[1], sa[2], sa[4]))
    return GEMV_VARIANTS[2 + int(ok)]


def gemv_rows_map(q: int, n: int, itemsize: int):
    """(lane, step, accumulator) of each element (q, b) of a row-major tile row: arrays of shape (q, n)."""
    v = vec(itemsize)
    nc = -(-n // v)
    t = np.arange(q)[:, None] * nc + np.arange(n)[None, :] // v
    return t % 32, t // 32, np.broadcast_to(np.arange(n) % v, (q, n))


def gemv_cols_slices(q: int, n: int):
    """[start, stop) of each warp's slice of the Q n columns of a column-major tile."""
    total = q * n
    per = -(-total // GEMV_WARPS)
    return [(min(total, w * per), min(total, (w + 1) * per)) for w in range(GEMV_WARPS)]


def _rows(a, x):
    """(Z, G, m, Q n) rows and (Z, G, 1, Q n) vectors, columns in (q, b) order."""
    z, g, q, m, n = a.shape
    rows = np.ascontiguousarray(np.moveaxis(a, 3, 2)).reshape(z, g, m, q * n)
    return rows, np.broadcast_to(x, (z, g, q, n)).reshape(z, g, 1, q * n)


def gemv_rows_rendition(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The row-major kernel's sums in its order: a (Z, G, Q, m, n), x (Z, G, Q, n) -> (Z, G, m)."""
    z, g, q, m, n = a.shape
    v = vec(a.itemsize)
    nc = -(-n // v)
    steps = -(-q * nc // 32)
    ap = np.zeros((z, g, m, q, nc * v), a.dtype)
    ap[..., :n] = np.moveaxis(a, 3, 2)
    xp = np.zeros((z, g, 1, q, nc * v), a.dtype)
    xp[..., :n] = np.broadcast_to(x, (z, g, q, n))[:, :, None]
    ap = np.concatenate([ap.reshape(z, g, m, q * nc, v), np.zeros((z, g, m, steps * 32 - q * nc, v), a.dtype)], 3)
    xp = np.concatenate([xp.reshape(z, g, 1, q * nc, v), np.zeros((z, g, 1, steps * 32 - q * nc, v), a.dtype)], 3)
    ap, xp = ap.reshape(z, g, m, steps, 32, v), xp.reshape(z, g, 1, steps, 32, v)
    acc = np.zeros((z, g, m, 32, v), a.dtype)
    for s in range(steps):
        acc = acc + ap[:, :, :, s] * xp[:, :, :, s]
    lane = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3]) if v == 4 else acc[..., 0] + acc[..., 1]
    for half in (16, 8, 4, 2, 1):
        lane = lane[..., :half] + lane[..., half:2 * half]
    return lane[..., 0]


def gemv_cols_rendition(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The column-major kernel's sums in its order (same operands and result as the row-major one)."""
    z, g, q, m, n = a.shape
    rows, xs = _rows(a, x)
    part = []
    for start, stop in gemv_cols_slices(q, n):
        acc = np.zeros((z, g, m), a.dtype)
        for k in range(start, stop):
            acc = acc + rows[..., k] * xs[..., k]
        part.append(acc)
    out = part[0]
    for p in part[1:]:
        out = out + p
    return out


# ---------------------------------------------------------------------------
# tile_trsv
# ---------------------------------------------------------------------------


def owned_blocks(nb: int, cluster: int, rank: int) -> int:
    return (nb - rank + cluster - 1) // cluster


def trsv_plan(m: int, itemsize: int):
    """{cluster, variant, smem_bytes} of the solve at (m, itemsize), as the source's ``trsv_plan``; None past it."""
    nb = -(-m // BLOCK)
    cluster = min(nb, MAX_CLUSTER)
    slot = BLOCK * (BLOCK + 16 // itemsize) * itemsize
    head = -(-nb * 8 // 16) * 16 + 2 * TRSV_WARPS * BLOCK * itemsize
    most, few = 0, True
    for c in range(cluster):
        owned = [c + t * cluster for t in range(owned_blocks(nb, cluster, c))]
        few = few and len(owned) <= TRSV_WARPS
        most = max(most, sum(i + 1 for i in owned), sum(nb - i for i in owned))
    resident = head + nb * BLOCK * itemsize + most * slot
    if few and resident <= MAX_SMEM:
        return {"cluster": cluster, "variant": "resident", "smem_bytes": resident}
    smem = head + TRSV_WARPS * (1 + RING) * slot
    return {"cluster": cluster, "variant": "streaming", "smem_bytes": smem} if smem <= MAX_SMEM else None


def trsv_owners(m: int, itemsize: int, transpose: bool):
    """(rank, warp) that solves each row block, and the order of a warp's blocks."""
    nb = -(-m // BLOCK)
    cluster = trsv_plan(m, itemsize)["cluster"]
    owners = {}
    for rank in range(cluster):
        owned = owned_blocks(nb, cluster, rank)
        for tt in range(owned):
            t = owned - 1 - tt if transpose else tt
            owners[rank + t * cluster] = (rank, tt % TRSV_WARPS, tt // TRSV_WARPS)
    return owners


def _dot4(terms: np.ndarray) -> np.ndarray:
    """Sum over the last axis (32 terms) into partials by index % 4, added as ((0 + 1) + (2 + 3))."""
    q = [np.zeros(terms.shape[:-1], terms.dtype) for _ in range(4)]
    for b in range(terms.shape[-1]):
        q[b % 4] = q[b % 4] + terms[..., b]
    return (q[0] + q[1]) + (q[2] + q[3])


def invert_block(d: np.ndarray) -> np.ndarray:
    """The kernel's inverse of a lower 32 x 32 block: column j by forward substitution (lane j)."""
    y = np.zeros((BLOCK, BLOCK), d.dtype)  # y[row, j]
    eye = np.eye(BLOCK, dtype=d.dtype)
    for row in range(BLOCK):
        q = [np.zeros(BLOCK, d.dtype) for _ in range(4)]
        for b in range(row):
            q[b % 4] = q[b % 4] + d[row, b] * y[b]
        y[row] = (eye[row] - ((q[0] + q[1]) + (q[2] + q[3]))) / d[row, row]
    return y


def trsv_rendition(l: np.ndarray, r: np.ndarray, transpose: bool) -> np.ndarray:
    """One system's solve in the kernel's order: l (m, m) lower (its upper triangle is not read), r (m,)."""
    m = l.shape[0]
    nb = -(-m // BLOCK)
    mp = nb * BLOCK
    lp = np.zeros((mp, mp), l.dtype)
    lp[:m, :m] = np.tril(l)
    lp[np.arange(m, mp), np.arange(m, mp)] = 1
    rp = np.zeros(mp, l.dtype)
    rp[:m] = r
    x = np.zeros(mp, l.dtype)

    def blk(i, k):
        return lp[i * BLOCK:(i + 1) * BLOCK, k * BLOCK:(k + 1) * BLOCK]

    order = range(nb - 1, -1, -1) if transpose else range(nb)
    for i in order:
        acc = rp[i * BLOCK:(i + 1) * BLOCK].copy()
        ks = range(nb - 1, i, -1) if transpose else range(i)
        for k in ks:
            xk = x[k * BLOCK:(k + 1) * BLOCK]
            terms = blk(k, i).T * xk[None, :] if transpose else blk(i, k) * xk[None, :]
            acc = acc - _dot4(terms)
        dinv = invert_block(blk(i, i))
        x[i * BLOCK:(i + 1) * BLOCK] = _dot4((dinv.T if transpose else dinv) * acc[None, :])
    return x[:m]
