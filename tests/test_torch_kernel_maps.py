"""The work maps of the port's redesigned CUDA kernels, on the CPU.

CUDA cannot run here, so this file mirrors in Python what the kernels decide
from their shapes, and checks it:

* ``csrc/flash_attention.cu``, the bf16 kernel: the CTA -> (batch, heads,
  query rows) map (every row of every head stored once), the key blocks a
  CTA loads (every unmasked key of its rows), the blocks it takes without
  the element-wise mask (none of their entries masked), and a plain
  rendition of its base-2 online softmax, with the rescale of O deferred
  until P_{n-1} V_{n-1} is added and the softcap as 1 - 2 / (1 + 2^u), held
  against the Pallas kernel (interpret mode) and the port's plain version;
* ``csrc/strip_solve.cuh``, the strip solve that the carry and TRSM kernels
  share: the strip heights that fit shared memory and the tile limits the
  wrappers and the notes state; TRSM's strip choice from G and m (and its
  pipeline depth), its CTA -> (task, rows) map, and a plain rendition of the
  solve's algebra (inverted 32 x 32 diagonal blocks padded with the
  identity, X_j = S_j D_j^T, the right-looking update) held against the
  Pallas kernel (interpret mode), the port's plain version and the gradient
  reference;
* ``csrc/cov_assembly.cu``: the CTA and thread -> output map (every element
  written once), the feature staging, and the ``ex2`` form of the exponential;
* ``csrc/lrgemm_tile.cu``: the block -> (task, rows) map;
* ``csrc/tile_gemv_trsv.cu`` (mirrored in ``tests/_tile_vector_maps.py``): the
  GEMV's (q, b) -> (lane, accumulator) map and its warps' column slices, with
  float32 renditions of both routes (width-invariant, near the einsum); the
  solve's plan (cluster size and variant from (m, dtype) alone), its row
  ownership over the cluster, and its blocked rendition against
  ``solve_triangular``.

``tests/test_torch_gpu.py`` holds the kernels themselves against their
plain versions on the card.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import trsm_tile as jtrsm
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
import _tile_vector_maps as tvm
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels import carry_update, flash_attention, lrgemm_tile, ops, trsm_tile

CSRC = Path(flash_attention.__file__).resolve().parent / "csrc"
NEG_INF = -(2.0**30)
LOG2E = 1.4426950408889634


def source_int(name: str, source: str) -> int:
    """The value of ``constexpr <int|size_t> name = <int>`` in ``csrc/<source>.cu`` (or ``csrc/<source>``)."""
    text = (CSRC / (source if "." in source else f"{source}.cu")).read_text()
    return int(re.search(rf"constexpr (?:int|size_t) (?:\w+ = \d+, )*{name} = (\d+)[;,]", text).group(1))


STRIP = "strip_solve.cuh"  # the strip solve shared by csrc/carry_update.cu and csrc/trsm_tile.cu


# ---------------------------------------------------------------------------
# flash attention (bf16 kernel)
# ---------------------------------------------------------------------------

BQ = BK = 64


def flash_ctas(b, s, t, h, kv, causal, window):
    """The kernel's CTAs in launch order: batch, KV head, two (head, first row, stored) slots, key blocks."""
    g = h // kv
    rows = 2 * BQ if g == 1 else BQ
    n_row_blocks = -(-s // rows)
    n_units = h if g == 1 else kv * -(-g // 2)
    per_rb = n_units * b
    for i in range(n_row_blocks * per_rb):
        rb = n_row_blocks - 1 - i // per_rb
        bb, u = divmod(i % per_rb, n_units)
        if g == 1:
            kvh = head0 = head1 = u
            row0 = rb * 2 * BQ
            keep1 = row0 + BQ < s
            row1 = row0 + BQ if keep1 else row0
        else:
            pairs = -(-g // 2)
            kvh = u // pairs
            head0 = kvh * g + 2 * (u % pairs)
            keep1 = 2 * (u % pairs) + 1 < g
            head1 = head0 + 1 if keep1 else head0
            row0 = row1 = rb * BQ
        last_row = min(row1 + BQ - 1, s - 1)
        col_lo, col_hi = 0, t - 1
        if causal:
            col_hi = min(col_hi, last_row)
        if window:
            col_lo = max(0, row0 - window + 1)
        blk_lo = col_lo // BK
        n_blk = col_hi // BK - blk_lo + 1 if col_hi >= col_lo else 0
        yield {"b": bb, "kvh": kvh, "slots": [(head0, row0, True), (head1, row1, keep1)],
               "blocks": range(blk_lo, blk_lo + n_blk)}


def full_block(key0, ra, t, causal, window):
    """The kernel's ``full``: no entry of keys key0 .. key0 + 63 is masked for rows ra .. ra + 63."""
    return (key0 + BK <= t and (not causal or key0 + BK - 1 <= ra)
            and (not window or key0 > ra + BQ - 1 - window))


def unmasked(r, c, t, causal, window):
    return c < t and (not causal or c <= r) and (not window or c > r - window)


MAP_SHAPES = [
    # (B, S, T, H, KV, causal, window): gemma2-2b's heads, H / KV of 1, 3 and 16, ragged S and T, S != T
    (2, 200, 200, 8, 4, True, None), (1, 333, 200, 16, 1, True, None), (2, 130, 333, 4, 4, True, None),
    (1, 129, 129, 3, 1, True, 1), (1, 300, 300, 8, 4, True, 100), (2, 100, 190, 8, 4, False, None),
    (1, 190, 100, 2, 1, True, 50), (1, 257, 257, 2, 2, True, 257),
]


def test_flash_source_constants_are_the_mirrors():
    assert source_int("BQ", "flash_attention") == BQ and source_int("BK", "flash_attention") == BK
    assert source_int("CONSUMERS", "flash_attention") == 2
    text = (CSRC / "flash_attention.cu").read_text()
    assert "STAGES = HD >= 256 ? 2 : 4" in text
    # the layout: two Q slots, then the K and V stages, then 1 + 4 STAGES barriers and the base's alignment
    for hd in flash_attention.HEAD_DIMS:
        stages = 2 if hd >= 256 else 4
        tile = 64 * hd * 2
        assert 2 * tile + 2 * stages * tile + 8 * (1 + 4 * stages) + 1024 <= source_int("MAX_SMEM", "flash_attention")


@pytest.mark.parametrize("shape", MAP_SHAPES)
def test_flash_map_stores_every_row_of_every_head_once(shape):
    b, s, t, h, kv, causal, window = shape
    stored = {}
    for cta in flash_ctas(b, s, t, h, kv, causal, window):
        for head, row0, keep in cta["slots"]:
            assert head // (h // kv) == cta["kvh"]
            if keep:
                for r in range(row0, min(row0 + BQ, s)):
                    key = (cta["b"], head, r)
                    stored[key] = stored.get(key, 0) + 1
    assert stored == {(bb, hh, r): 1 for bb in range(b) for hh in range(h) for r in range(s)}


def test_flash_map_runs_the_longest_query_blocks_first():
    rows0 = [cta["slots"][0][1] for cta in flash_ctas(4, 2048, 2048, 8, 4, True, None)]
    assert rows0 == sorted(rows0, reverse=True) and len(rows0) == 4 * 4 * 32


@pytest.mark.parametrize("shape", MAP_SHAPES)
def test_flash_key_blocks_cover_every_unmasked_key_and_full_blocks_mask_nothing(shape):
    b, s, t, h, kv, causal, window = shape
    for cta in flash_ctas(b, s, t, h, kv, causal, window):
        cols = range(cta["blocks"].start * BK, min(cta["blocks"].stop * BK, t))
        for head, ra, keep in cta["slots"]:
            for r in range(ra, min(ra + BQ, s)):
                need = {c for c in range(t) if unmasked(r, c, t, causal, window)}
                assert need <= set(cols), (cta, r)
            for blk in cta["blocks"]:
                if full_block(blk * BK, ra, t, causal, window):
                    assert all(unmasked(r, c, t, causal, window)
                               for r in range(ra, min(ra + BQ, s)) for c in range(blk * BK, blk * BK + BK))


def capped_log2(x, scale, softcap):
    """The kernel's scores in base 2: softcap (1 - 2 / (1 + 2^u)) log2(e), u = 2 log2(e) x scale / softcap."""
    if softcap is None:
        return x  # scaled in the exponent's FMA
    e = torch.exp2(x * (2 * LOG2E * scale / softcap))
    return (softcap * LOG2E) - (2 * softcap * LOG2E) / (1 + e)


def flash_rendition(q, k, v, *, causal=True, softcap=None, window=None, round_p=False):
    """The bf16 kernel's arithmetic on float32 tensors, CTA by CTA, consumer warpgroup by warpgroup."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    kf = 1.0 if softcap is not None else scale * LOG2E  # the factor between y and the exponent
    pad = lambda x, n: torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])]) if x.shape[0] < n else x
    out = torch.full_like(q, float("nan"))
    for cta in flash_ctas(b, s, t, h, kv, causal, window):
        bb, kvh = cta["b"], cta["kvh"]
        for head, ra, keep in cta["slots"]:
            qs = pad(q[bb, ra:ra + BQ, head], BQ)  # rows past S arrive as zeros
            m = torch.full((BQ,), NEG_INF)
            l = torch.zeros(BQ)
            o = torch.zeros(BQ, hd)
            prev = None
            for n, blk in enumerate(cta["blocks"]):
                key0 = blk * BK
                kb, vb = (pad(x[bb, key0:key0 + BK, kvh], BK) for x in (k, v))  # keys past T: zeros
                y = capped_log2(qs @ kb.T, scale, softcap)
                if not full_block(key0, ra, t, causal, window):
                    rr = torch.arange(ra, ra + BQ)[:, None]
                    cc = torch.arange(key0, key0 + BK)[None, :]
                    ok = (cc < t).expand(BQ, BK).clone()
                    if causal:
                        ok &= cc <= rr
                    if window:
                        ok &= cc > rr - window
                    y = y.masked_fill(~ok, float("-inf"))
                m_new = torch.maximum(m, y.amax(1) * kf)
                c = torch.exp2(m - m_new)
                p = torch.exp2(y * kf - m_new[:, None])
                l = l * c + p.sum(1)
                if prev is not None:  # P_{n-1} V_{n-1} lands, then O is rescaled
                    o = (o + prev[0] @ prev[1]) * c[:, None]
                prev = (p.bfloat16().float() if round_p else p, vb)
                m = m_new
            if prev is not None:
                o = o + prev[0] @ prev[1]
            if keep:
                rows = min(BQ, s - ra)
                out[bb, ra:ra + rows, head] = (o / l.clamp_min(1e-30)[:, None])[:rows]
    return out


@pytest.mark.parametrize("softcap", [None, 10.0])
def test_flash_rendition_matches_pallas(rng, softcap):
    b, s, h, kv, hd = 2, 128, 8, 4, 16
    arrs = [rng.standard_normal((b, s, n, hd)).astype(np.float32) * 2 for n in (h, kv, kv)]
    want = pallas_flash_attention(*(jnp.asarray(a) for a in arrs), causal=True, softcap=softcap,
                                  block_q=32, block_k=32)
    got = flash_rendition(*(torch.from_numpy(a) for a in arrs), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("shape", MAP_SHAPES)
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_flash_rendition_matches_the_plain_version(rng, shape, softcap):
    """float32 throughout at 5e-5 (the reference's tolerance); P rounded to bf16 as the kernel does at 2e-2."""
    b, s, t, h, kv, causal, window = shape
    q = torch.from_numpy(rng.standard_normal((b, s, h, 32)).astype(np.float32) * 3)
    k, v = (torch.from_numpy(rng.standard_normal((b, t, kv, 32)).astype(np.float32)) for _ in range(2))
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, softcap=softcap, window=window)
    got = flash_rendition(q, k, v, causal=causal, softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)
    got16 = flash_rendition(q, k, v, causal=causal, softcap=softcap, window=window, round_p=True)
    assert float(((got16 - want).abs() / want.abs().clamp_min(1.0)).max()) <= 2e-2


def test_softcap_identity_is_exact_to_float32_rounding():
    """cap (1 - 2 / (1 + 2^(2 log2(e) x / cap))) against cap tanh(x / cap), in float32, |x| up to 40 cap."""
    cap = np.float32(50.0)
    x = np.linspace(-2000.0, 2000.0, 400001, dtype=np.float32)
    u = x * np.float32(2 * LOG2E / 50.0)
    with np.errstate(over="ignore"):
        ident = cap - np.float32(2) * cap / (np.float32(1) + np.exp2(u))
    exact = 50.0 * np.tanh(x.astype(np.float64) / 50.0)
    assert np.isfinite(ident).all()
    assert float(np.abs(ident - exact).max()) <= 4 * np.spacing(cap)  # a few ulp of the cap, about 1e-7 of it


# ---------------------------------------------------------------------------
# the strip solve (carry and TRSM): strip heights, limits, TRSM's map
# ---------------------------------------------------------------------------


def strip_bytes(m, rs, size, depth=None):
    """Strip<T, RS, DEPTH>::bytes(m): the strip, two stages of DEPTH rows of the streamed panel, region R and
    D_j^T (DEPTH = BK by default)."""
    threads, cb, bk = (source_int(n, STRIP) for n in ("THREADS", "CB", "BK"))
    depth = depth or bk
    ch = 16 // size
    v = min(rs // 8, ch)
    ty = rs // (2 * v)
    bn = 2 * v * (threads // ty)
    lds = -(-m // 32) * 32 + 4
    return (rs * lds + 2 * depth * (bn + ch) + cb * (rs + v) + cb * (cb + ch)) * size


STRIPS = {4: (32, 16, 8), 8: (16, 8)}  # the launcher's strips, tallest first: float32, float64
SMS = 132  # the H100 SXM's SMs; the TRSM launcher reads the count from the device


def fits(m, rs, size, depth=None):
    return strip_bytes(m, rs, size, depth) <= source_int("MAX_SMEM", STRIP)


def strip_for(m, size):
    """strip::tallest_fit, the carry kernel's strip."""
    return next((rs for rs in STRIPS[size] if fits(m, rs, size)), None)


def trsm_strip(g, m, size, sms=SMS):
    """strip::covering: the tallest strip that fits m and whose grid covers the SMs, else the shortest."""
    pick = None
    for rs in STRIPS[size]:
        if not fits(m, rs, size):
            continue
        pick = rs
        if g * -(-m // rs) >= sms:
            return rs
    return pick


def trsm_depth(rs, m, size):
    """trsm_tile.cu's deep(): rows of k in a stage of Lt, SHORT_DEPTH on a strip shorter than the type's tallest
    where its stages fit, else BK."""
    depth = source_int("SHORT_DEPTH", "trsm_tile")
    return depth if rs < STRIPS[size][0] and fits(m, rs, size, depth) else source_int("BK", STRIP)


def largest_m(rs, size):
    m = 1
    while fits(m + 1, rs, size):
        m += 1
    return m


@pytest.mark.parametrize("size", [4, 8])
def test_carry_keeps_the_tall_strip_at_m_512(size):
    tall = STRIPS[size][0]
    assert strip_for(512, size) == tall
    # two CTAs an SM at m = 512 (228 KB of shared memory an SM, 1 KB of it reserved per CTA)
    assert 2 * (strip_bytes(512, tall, size) + 1024) <= 228 * 1024


@pytest.mark.parametrize("size,tall_limit,limit", [(4, 1472, 6816), (8, 1440, 3168)])
def test_carry_limits_are_the_documented_ones(size, tall_limit, limit):
    assert largest_m(STRIPS[size][0], size) == tall_limit
    assert largest_m(STRIPS[size][-1], size) == limit
    assert strip_for(2048, size) == (16 if size == 4 else 8) and strip_for(limit + 1, size) is None
    note = (CSRC / "carry_update.cu").read_text()
    assert str(limit) in carry_update.__doc__ and str(limit) in note and str(tall_limit) in note


@pytest.mark.parametrize("size,rs", [(4, 32), (4, 16), (4, 8), (8, 16), (8, 8)])
def test_carry_strip_thread_tiles_cover_the_strip(size, rs):
    """V = min(RS / 8, a 16-byte vector): a warp still covers 4 x 8 threads, and the CTA's rows are the strip."""
    v = min(rs // 8, 16 // size)
    ty = rs // (2 * v)
    assert ty % 4 == 0 and (256 // ty) % 8 == 0 and 2 * v * ty == rs


def test_strip_constants_live_in_the_shared_header():
    """Neither kernel keeps its own copy of the solve: both include the header and neither defines its constants."""
    for source in ("carry_update", "trsm_tile"):
        text = (CSRC / f"{source}.cu").read_text()
        assert '#include "strip_solve.cuh"' in text
        assert not re.search(r"constexpr (?:int|size_t) (THREADS|CB|BK|MAX_SMEM) =", text)
        assert "strip::solve<" in text and "strip::launch_prep<" in text


def test_trsm_strip_follows_g_and_m():
    # a launch of one tile at m = 512 runs 8-row strips on 64 CTAs, not 8 CTAs of 64 rows
    assert trsm_strip(1, 512, 4) == 8 and 1 * -(-512 // 8) >= 64
    # the column-0 panel of gp_16k (G = 31) keeps the carry kernel's tall strip, two CTAs an SM
    assert trsm_strip(31, 512, 4) == 32 == strip_for(512, 4)
    assert trsm_depth(32, 512, 4) == 8
    # the cold call's 31 launches: 32-row strips down to G = 9, 16 rows for G = 5..8, 8 rows below
    assert [trsm_strip(g, 512, 4) for g in range(31, 0, -1)] == [32] * 23 + [16] * 4 + [8] * 4
    assert [trsm_depth(rs, 512, 4) for rs in (16, 8)] == [32, 32]
    # float64: 16-row strips where they cover the SMs, else 8
    assert trsm_strip(31, 512, 8) == 16 and trsm_strip(1, 512, 8) == 8 and trsm_depth(8, 512, 8) == 32
    # gp_32k's tile: G = 1 at m = 1024 has no strip that covers the SMs, so the shortest
    assert trsm_strip(1, 1024, 4) == 8 and trsm_strip(31, 1024, 4) == 32


@pytest.mark.parametrize("size,limit", [(4, 6816), (8, 3168)])
def test_trsm_limits_are_the_strip_solves(size, limit):
    """TRSM takes every tile the shortest strip fits, with stages of BK rows where the deeper ones do not."""
    assert largest_m(8, size) == limit
    assert trsm_strip(1, limit, size) == 8 and trsm_depth(8, limit, size) == source_int("BK", STRIP)
    assert trsm_strip(1, limit + 1, size) is None
    assert trsm_strip(10**6, limit, size) == 8  # no taller strip fits, however many tiles
    note = (CSRC / "trsm_tile.cu").read_text()
    assert str(limit) in trsm_tile.__doc__ and str(limit) in note


@pytest.mark.parametrize("g,m,size", [(1, 512, 4), (31, 512, 4), (2, 100, 4), (3, 77, 8), (6, 512, 4), (1, 33, 8),
                                      (40, 100, 4), (1, 1024, 4)])
def test_trsm_ctas_solve_every_row_of_every_tile_once(g, m, size):
    rs = trsm_strip(g, m, size)
    strips = -(-m // rs)
    seen = []
    for block in range(g * strips):
        task, r0 = block // strips, block % strips * rs
        seen += [(task, r) for r in range(r0, min(r0 + rs, m))]
    assert seen == [(task, r) for task in range(g) for r in range(m)]


def inverted_diagonal_blocks(l, cb=32):
    """prep's D_j^T: the inverse of each 32 x 32 diagonal block of L, padded with the identity past m, transposed.

    Column c of D_j = L_jj^{-1} by forward substitution, as lane c of the prep's warp runs it.
    """
    g, m, _ = l.shape
    nb = -(-m // cb)
    lp = torch.eye(nb * cb, dtype=l.dtype).repeat(g, 1, 1)
    lp[:, :m, :m] = torch.tril(l)
    dt = torch.zeros(g, nb, cb, cb, dtype=l.dtype)
    for j in range(nb):
        blk = lp[:, j * cb:(j + 1) * cb, j * cb:(j + 1) * cb]
        z = torch.zeros(g, cb, cb, dtype=l.dtype)  # z[:, r, c]: row r of column c of D_j
        for r in range(cb):
            v = torch.eye(cb, dtype=l.dtype)[r].expand(g, cb) - torch.einsum("gq,gqc->gc", blk[:, r, :r], z[:, :r])
            z[:, r] = v / blk[:, r, r, None]
        dt[:, j] = z.mT  # row c of D_j^T is column c of D_j
    return lp, dt


def strip_solve_rendition(l, b, rs, cb=32):
    """X L^T = B by the strip kernel's algebra, strip by strip of rs rows, in the operands' type."""
    g, m, _ = b.shape
    nb = -(-m // cb)
    lp, dt = inverted_diagonal_blocks(l, cb)
    x = torch.empty_like(b)
    for r0 in range(0, m, rs):
        rows = min(rs, m - r0)
        s = torch.zeros(g, rs, nb * cb, dtype=b.dtype)  # the strip, zero past m in both directions
        s[:, :rows, :m] = b[:, r0:r0 + rows]
        for j in range(nb):
            cols = slice(j * cb, (j + 1) * cb)
            xj = s[:, :, cols] @ dt[:, j]  # X_j = S_j D_j^T
            s[:, :, cols] = xj
            rest = slice((j + 1) * cb, nb * cb)  # S -= X_j L[>j, j]^T
            s[:, :, rest] -= xj @ lp[:, rest, cols].mT
        x[:, r0:r0 + rows] = s[:, :rows, :m]
    return x


def _lower_stack(rng, g, m, dtype):
    """Cholesky factors of I + R R^T / m: the well-conditioned L of the port's kernel tests."""
    r = rng.standard_normal((g, m, m))
    return np.linalg.cholesky(np.eye(m) + r @ r.transpose(0, 2, 1) / m).astype(dtype)


def test_inverted_diagonal_blocks_are_padded_with_the_identity(rng):
    l = torch.from_numpy(_lower_stack(rng, 2, 40, np.float64))
    lp, dt = inverted_diagonal_blocks(l)
    for j in range(2):
        blk = lp[:, j * 32:(j + 1) * 32, j * 32:(j + 1) * 32]
        torch.testing.assert_close(dt[:, j].mT @ blk, torch.eye(32, dtype=torch.float64).expand(2, 32, 32),
                                   rtol=0, atol=1e-12)
    assert torch.equal(dt[:, 1, 8:, 8:], torch.eye(24, dtype=torch.float64).expand(2, 24, 24))  # past m = 40


@pytest.mark.parametrize("m", [8, 33, 64, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_strip_solve_rendition_matches_plain_ref_and_pallas(rng, m, dtype):
    """float32 within 1e-3, float64 within 1e-10 m, against trsm_plain, ops._trsm_ref and (float32) the Pallas kernel."""
    g = 3 if m <= 64 else 2
    l = _lower_stack(rng, g, m, dtype)
    b = rng.standard_normal((g, m, m)).astype(dtype)
    lt, bt = torch.from_numpy(l), torch.from_numpy(b)
    tol = 1e-3 if dtype == np.float32 else 1e-10 * m
    want = trsm_tile.trsm_plain(lt, bt)
    for size in (4, 8):
        for rs in STRIPS[size]:
            got = strip_solve_rendition(lt, bt, rs)
            assert float((got - want).abs().max()) <= tol
    torch.testing.assert_close(got, ops._trsm_ref(lt, bt), rtol=0, atol=tol)
    if dtype == np.float32:
        for i in range(g):
            pallas = np.asarray(jtrsm.trsm(jnp.asarray(l[i]), jnp.asarray(b[i]), interpret=True))
            np.testing.assert_allclose(got[i].numpy(), pallas, atol=tol)


# ---------------------------------------------------------------------------
# cov_tiles: the thread map and the exponential
# ---------------------------------------------------------------------------


def cov_geometry(size):
    """(BM, BN, V, TY, TX): the CTA's block and the thread tile of csrc/cov_assembly.cu on gemm_core.cuh's layout."""
    ty, tx = source_int("TY", "cov_assembly"), source_int("TX", "cov_assembly")
    v = 16 // size
    return 2 * v * ty, 2 * v * tx, v, ty, tx


def tile_thread(tid, v, ty_n, tx_n):
    """gemm::Tile's (row(i), col(j)) of thread tid."""
    warp, lane = tid >> 5, tid & 31
    wx = warp % (tx_n // 8)
    ty = (warp // (tx_n // 8)) * 4 + (lane >> 3)
    tx = wx * 8 + (lane & 7)
    bm, bn = 2 * v * ty_n, 2 * v * tx_n
    rows = [(i // v) * (bm // 2) + ty * v + i % v for i in range(2 * v)]
    cols = [(j // v) * (bn // 2) + tx * v + j % v for j in range(2 * v)]
    return rows, cols


@pytest.mark.parametrize("t,m,mb,size", [(2, 100, 60, 4), (1, 130, 140, 4), (1, 512, 512, 4), (2, 77, 45, 4),
                                         (2, 70, 71, 8), (1, 200, 64, 8)])
def test_cov_tiles_threads_write_every_output_once(t, m, mb, size):
    bm, bn, v, ty_n, tx_n = cov_geometry(size)
    threads = source_int("THREADS", "cov_assembly")
    assert ty_n * tx_n == threads and bm + bn <= threads  # one thread per row norm and per column norm
    vec = mb % v == 0  # the launcher's 16-byte-store instantiation
    rbs, cbs = -(-m // bm), -(-mb // bn)
    count = np.zeros((t, m, mb), dtype=np.int64)
    thread_tiles = [tile_thread(tid, v, ty_n, tx_n) for tid in range(threads)]
    for block in range(t * rbs * cbs):
        tt, rb, cb = block // (rbs * cbs), block // cbs % rbs, block % cbs
        for rows, cols in thread_tiles:
            for r in rows:
                if rb * bm + r >= m:
                    continue
                for h in range(2):
                    c = cb * bn + cols[h * v]
                    for e in range(v):
                        if (c < mb) if vec else (c + e < mb):
                            count[tt, rb * bm + r, c + e] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("rows,d", [(128, 16), (128, 40), (64, 1), (128, 3), (64, 33)])
def test_cov_tiles_staging_takes_every_feature_once(rows, d):
    """Chunks of up to KC features: element e of a chunk is (row e // kc, feature d0 + e % kc), every one once."""
    kc_max, threads = source_int("KC", "cov_assembly"), source_int("THREADS", "cov_assembly")
    seen = []
    for d0 in range(0, d, kc_max):
        kc = min(kc_max, d - d0)
        for tid in range(threads):
            seen += [(e // kc, d0 + e % kc) for e in range(tid, rows * kc, threads)]
    assert sorted(seen) == [(r, k) for r in range(rows) for k in range(d)]


def test_ex2_form_matches_exp_to_float32_rounding(rng):
    """v 2^((coef log2 e) d2), the scaled coefficient rounded once to float32, against v exp(coef d2).

    Over the squared distances of NFIR-scaled data (features of O(1 / sqrt(2 D))), and for the
    lengthscales 0.5, 1 and 3: within 2 ulp of the float32 exponential plus the exponent's share of the
    coefficient's rounding, |coef log2 e d2| 2^-24.
    """
    x = (rng.standard_normal((4096, 16)) / np.sqrt(32.0)).astype(np.float32)
    xt = torch.from_numpy(x)
    d2_max = float(torch.cdist(xt[:512], xt).max() ** 2)
    d2 = np.linspace(0.0, 4 * d2_max, 200001, dtype=np.float32)
    for lengthscale in (0.5, 1.0, 3.0):
        coef = -0.5 / lengthscale
        scaled = np.float32(coef * LOG2E)  # formed on the host in double, rounded once
        got = np.exp2(scaled * d2, dtype=np.float32)
        exact = np.exp(coef * d2.astype(np.float64))
        ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(got - exact) <= 2 * ulp + np.abs(scaled * d2) * 2.0**-24 * exact)
    assert "ex2.approx" in (CSRC / "cov_assembly.cu").read_text()


# ---------------------------------------------------------------------------
# LRGEMM: the block map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g,m", [(3, 512), (5, 100), (2, 7), (1, 8)])
def test_lrgemm_blocks_cover_every_row_once_in_memory_order(g, m):
    warps = source_int("WARPS", "lrgemm_tile")
    row_blocks = -(-m // warps)
    seen = []
    for block in range(g * row_blocks):
        task, rb = divmod(block, row_blocks)
        seen += [(task, r) for r in range(rb * warps, min(rb * warps + warps, m))]
    assert seen == [(task, r) for task in range(g) for r in range(m)]  # with a = arange: addresses ascend
    assert "8 warps" in lrgemm_tile.__doc__


# ---------------------------------------------------------------------------
# tile_gemv and tile_trsv (csrc/tile_gemv_trsv.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,n,itemsize", [(1, 512, 4), (8, 512, 4), (2, 77, 4), (3, 100, 8), (1, 16, 8), (7, 129, 4)])
def test_tile_gemv_row_map_takes_every_element_once(q, n, itemsize):
    """Each (q, b) of a tile row goes to one (lane, step, accumulator); a lane's chunks run in (q, b) order."""
    lane, step, acc = tvm.gemv_rows_map(q, n, itemsize)
    keys = list(zip(lane.ravel().tolist(), step.ravel().tolist(), acc.ravel().tolist()))
    assert len(set(keys)) == q * n
    assert lane.min() >= 0 and lane.max() < 32 and acc.max() < tvm.vec(itemsize)
    order = np.argsort(step.ravel() * 32 + lane.ravel(), kind="stable")  # the kernel's t, chunk by chunk
    assert np.all(np.diff(order) > 0)


@pytest.mark.parametrize("q,n", [(1, 512), (7, 1), (2, 77), (1, 5), (3, 129), (8, 512)])
def test_tile_gemv_column_slices_cover_every_column_once(q, n):
    slices = tvm.gemv_cols_slices(q, n)
    assert len(slices) == source_int("kGemvThreads", "tile_gemv_trsv") // 32
    assert [k for start, stop in slices for k in range(start, stop)] == list(range(q * n))


@pytest.mark.parametrize("route", ["rows", "cols"])
@pytest.mark.parametrize("shape", [(4, 2, 2, 64, 100), (4, 1, 3, 77, 33), (2, 3, 1, 33, 512), (4, 1, 1, 16, 5)])
def test_tile_gemv_rendition_is_width_invariant_and_near_the_einsum(rng, route, shape):
    """The float32 rendition of a route: Z problems and their first Z/2 bitwise alike, within 1e-5 x scale of a
    float64 einsum and of the port's plain version."""
    from repro_torch.kernels import tile_gemv_trsv

    z, g, q, m, n = shape
    a = (rng.standard_normal(shape) / np.sqrt(n)).astype(np.float32)
    x = rng.standard_normal((z, 1, q, n)).astype(np.float32)  # broadcast over g, as the XGEMV's alpha
    rendition = tvm.gemv_rows_rendition if route == "rows" else tvm.gemv_cols_rendition
    whole = rendition(a, x)
    assert whole.dtype == np.float32 and whole.shape == (z, g, m)
    assert np.array_equal(whole[: z // 2], rendition(a[: z // 2], x[: z // 2]))
    want = np.einsum("zgqab,zgqb->zga", a.astype(np.float64), np.broadcast_to(x, (z, g, q, n)).astype(np.float64))
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(whole - want).max() <= 1e-5 * scale
    plain = tile_gemv_trsv.tile_gemv_plain(torch.from_numpy(a), torch.from_numpy(x).expand(z, g, q, n))
    assert np.abs(whole - plain.numpy()).max() <= 1e-5 * scale


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m", [16, 77, 512, 1024])
def test_tile_trsv_cluster_owns_every_row_once(m, itemsize, transpose):
    """Row block i goes to rank i % C, each (rank, warp, turn) one block, a warp's blocks in the chain's order."""
    nb = -(-m // 32)
    cluster = tvm.trsv_plan(m, itemsize)["cluster"]
    owners = tvm.trsv_owners(m, itemsize, transpose)
    assert sorted(owners) == list(range(nb))
    assert sorted(r for i in owners for r in range(32 * i, min(m, 32 * i + 32))) == list(range(m))
    assert len(set(owners.values())) == nb and all(rank == i % cluster for i, (rank, _, _) in owners.items())
    by_warp = {}
    for i, (rank, warp, turn) in owners.items():
        by_warp.setdefault((rank, warp), []).append((turn, i))
    for blocks in by_warp.values():
        chain = [i for _, i in sorted(blocks)]
        assert chain == sorted(chain, reverse=transpose)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [16, 77, 100, 512])
def test_tile_trsv_rendition_matches_solve_triangular(rng, m, dtype, transpose):
    """The blocked rendition (inverted diagonal blocks, four partials) against a float64 solve, at the kernel's
    tolerance: 1e-4 x scale, 1e-3 x scale for float32 at m >= 512; L's upper triangle holds garbage it never reads."""
    a = rng.standard_normal((m, m)) / np.sqrt(m)
    low = np.linalg.cholesky(a @ a.T + np.eye(m)).astype(dtype) + np.triu(rng.standard_normal((m, m)), 1).astype(dtype)
    r = rng.standard_normal(m).astype(dtype)
    got = tvm.trsv_rendition(low, r, transpose)
    lo = torch.from_numpy(np.tril(low).astype(np.float64))
    want = torch.linalg.solve_triangular(lo.mT if transpose else lo, torch.from_numpy(r.astype(np.float64))[:, None],
                                         upper=transpose)[:, 0].numpy()
    tol = 1e-3 if dtype == np.float32 and m >= 512 else 1e-4
    assert got.dtype == dtype
    assert np.abs(got - want).max() <= tol * max(1.0, float(np.abs(want).max()))


def test_tile_trsv_plan_is_a_function_of_m_and_dtype():
    """The launcher takes its plan from (m, sizeof(T)) alone; the variants' ranges are the source's note."""
    text = tvm.SOURCE.read_text()
    assert "inline TrsvPlan trsv_plan(int m, int elem) {" in text
    assert "const TrsvPlan pl = trsv_plan(m, sizeof(T));" in text
    note = " ".join(line.strip("/ ") for line in text.splitlines() if line.startswith("//"))
    assert "(m up to 768 in float32, 512 in float64)" in note and "479232 (float32) and 77824 (float64)" in note
    for itemsize, last_resident, last in ((4, 768, 479232), (8, 512, 77824)):
        plan = {m: tvm.trsv_plan(m, itemsize) for m in (*range(1, last_resident + 2, 7), last_resident + 1)}
        assert all(p["variant"] == ("resident" if m <= last_resident else "streaming") for m, p in plan.items())
        assert all(p["cluster"] == min(8, -(-m // 32)) for m, p in plan.items())
        assert tvm.trsv_plan(last, itemsize)["variant"] == "streaming" and tvm.trsv_plan(last + 1, itemsize) is None
