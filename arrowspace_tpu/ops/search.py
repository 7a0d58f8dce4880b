"""Batched λ-aware search.

The reference scans all N items per query, computing
α·cos(q, x_i) + (1-α)·(1 - min(|λ_q - λ_i|, 1)) and sorting
(reference: core.rs:760-798).  Here that is one normalised matmul
(Q̂ @ X̂ᵀ) plus elementwise λ-proximity and ``lax.top_k`` — the
per-thread-heap merge of the hybrid variant (core.rs:818-888) is
subsumed by a single fused top-k.

Every full-scan path (the sessions, core.search_lambda_aware_batch, the
live sessions and every mesh shard) scores through ONE step,
``lambda_topk``.  When the (B, N) score plane fits SCORE_PLANE_BYTES it
is materialised and reduced by one ``lax.top_k``; past the budget the
corpus is scanned in fixed row chunks with a running top-k
(``scan_topk``), so the working set stays O(B·chunk) at any N.

Precision: f32 score dots run at ``lax.Precision.HIGHEST`` — without it
an f32 matmul may run in TF32 on tensor-core GPUs, which keeps ~3
decimal digits and would break the 1e-5 score contract.  The explicit
``use_bf16`` option is the one accuracy-for-speed trade: the plane is
scored with bf16 operands and f32 accumulation, and its top
BF16_POOL·k candidates are rescored exactly (HIGHEST) before the final
top-k — bf16 alone (~2^-9 relative) reorders clustered neighbours whose
scores differ by ~1e-4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HIGHEST, SCORE_PLANE_BYTES

# bf16 screening pool: candidates per result slot rescored in f32.
BF16_POOL = 4

__all__ = ["cosine_scores", "lambda_aware_scores", "lambda_topk",
           "batched_lambda_aware_topk", "scan_topk", "plane_chunk_rows",
           "rescore_topk_f64"]


def rescore_topk_f64(queries, query_lambdas, host_rows, item_lambdas,
                     alpha: float, cand_idx, k: int):
    """Exact f64 re-ranking of device-produced candidates.

    The f32 device scan can flip ties among near-duplicate cosines (the
    0.959-recall regime on clustered 384-d data); re-scoring the candidate
    pool against the ORIGINAL f64 rows restores the f64 ordering at
    O(B·m·F) host flops — negligible next to the O(B·N·F) device scan.
    Item λ values stay f32-computed (within the 1e-5 budget; only the
    cosine term carries the tie-flipping error at α near 1).

    Returns (scores (B, k) f64, indices (B, k)).
    """
    q = np.asarray(queries, dtype=np.float64)
    qlam = np.asarray(query_lambdas, dtype=np.float64)
    lam = np.asarray(item_lambdas, dtype=np.float64)
    cand = np.asarray(cand_idx)
    bsz, m = cand.shape

    rows = np.asarray(host_rows, dtype=np.float64)[cand]     # (B, m, F)
    qn = np.linalg.norm(q, axis=1)
    rn = np.linalg.norm(rows, axis=2)
    dots = np.einsum("bf,bmf->bm", q, rows)
    denom = qn[:, None] * rn
    cos = np.where(denom > 0.0, dots / np.where(denom > 0.0, denom, 1.0),
                   0.0)
    dl = np.abs(qlam[:, None] - lam[cand])
    scores = alpha * cos + (1.0 - alpha) * (1.0 - np.minimum(dl, 1.0))

    # ties resolve to the lowest GLOBAL index (lax.top_k semantics), not
    # the candidate pool position
    top_scores = np.empty((bsz, k), dtype=np.float64)
    top_idx = np.empty((bsz, k), dtype=cand.dtype)
    for b in range(bsz):
        order = np.lexsort((cand[b], -scores[b]))[:k]
        top_scores[b] = scores[b][order]
        top_idx[b] = cand[b][order]
    return top_scores, top_idx


def _safe_unit(rows: jax.Array) -> jax.Array:
    norms = jnp.sqrt(jnp.sum(rows * rows, axis=-1, keepdims=True))
    return jnp.where(norms > 0.0, rows / jnp.where(norms > 0.0, norms, 1.0), 0.0)


def score_dot(q: jax.Array, x: jax.Array, use_bf16: bool = False
              ) -> jax.Array:
    """(B, F) x (N, F) -> (B, N) row dots, the one score-plane matmul.

    f32/f64 operands run at Precision.HIGHEST (never TF32); use_bf16
    casts both operands to bf16 and accumulates in f32."""
    dims = (((1,), (1,)), ((), ()))
    if use_bf16:
        out = jax.lax.dot_general(
            q.astype(jnp.bfloat16), x.astype(jnp.bfloat16), dims,
            preferred_element_type=jnp.float32)
        return out.astype(q.dtype)
    return jax.lax.dot_general(q, x, dims, precision=HIGHEST,
                               preferred_element_type=q.dtype)


@jax.jit
def cosine_scores(queries: jax.Array, items: jax.Array) -> jax.Array:
    """(B, F) x (N, F) -> (B, N) cosine similarity; zero vectors score 0
    (reference: core.rs:229-239).  Precision.HIGHEST."""
    return score_dot(_safe_unit(queries), _safe_unit(items))


def plane_chunk_rows(b: int, n: int, k: int,
                     budget: int = SCORE_PLANE_BYTES) -> int:
    """Rows per scan chunk for a (b, n) score plane: n itself when the
    f32 plane fits `budget`, else the largest row count whose (b, rows)
    plane does (never below k, so each chunk can supply k candidates)."""
    if b * n * 4 <= budget:
        return n
    return min(n, max(k, budget // (4 * b)))


def scan_topk(score_rows, n: int, b: int, k: int, chunk: int, dtype,
              n_live=None):
    """Top-k over n corpus rows scored in chunks.

    ``score_rows(start, rows)`` returns the (b, rows) scores of corpus
    rows [start, start + rows).  With chunk >= n the plane is scored in
    one piece and reduced by one ``lax.top_k``.  Otherwise a
    ``lax.scan`` walks ceil(n / chunk) chunks of exactly `chunk` rows;
    the last one is clamped to end at row n and masks the rows an
    earlier chunk already covered, so no padded copy of the corpus is
    ever made.  Each chunk's top-k merges into the running (b, k)
    buffer, which is concatenated BEFORE the chunk's candidates — with
    ``lax.top_k`` resolving exact ties to the lower position, equal
    scores resolve to the lowest global index, as over the full plane.

    ``n_live`` (traced int, optional) masks rows >= n_live to -inf: one
    compiled program serves every live count of a capacity-padded
    corpus.  Returns (scores (b, k), indices (b, k) int32)."""
    neg_inf = jnp.asarray(-jnp.inf, dtype=dtype)
    if chunk >= n:
        sc = score_rows(0, n)
        if n_live is not None:
            sc = jnp.where(jnp.arange(n)[None, :] < n_live, sc, neg_inf)
        s, i = jax.lax.top_k(sc, k)
        return s, i.astype(jnp.int32)
    assert k <= chunk < n, (k, chunk, n)
    n_eff = n if n_live is None else n_live
    iota = jnp.arange(chunk, dtype=jnp.int32)

    def body(carry, c):
        run_s, run_i = carry
        lo = c * chunk
        start = jnp.minimum(lo, n - chunk)
        gidx = start + iota
        sc = score_rows(start, chunk)
        sc = jnp.where(((gidx >= lo) & (gidx < n_eff))[None, :], sc,
                       neg_inf)
        s_c, i_c = jax.lax.top_k(sc, k)
        cs = jnp.concatenate([run_s, s_c], axis=1)          # (b, 2k)
        ci = jnp.concatenate([run_i, i_c.astype(jnp.int32) + start],
                             axis=1)
        s2, pos = jax.lax.top_k(cs, k)
        return (s2, jnp.take_along_axis(ci, pos, axis=1)), None

    init = (jnp.full((b, k), neg_inf, dtype=dtype),
            jnp.zeros((b, k), dtype=jnp.int32))
    n_chunks = -(-n // chunk)
    (s, i), _ = jax.lax.scan(body, init,
                             jnp.arange(n_chunks, dtype=jnp.int32))
    return s, i


def _shifted_lambda_plane(queries, query_lambdas, items, item_lambdas,
                          alpha, use_bf16: bool = False):
    """The canonical score arithmetic, SHIFTED by -c1 = -(1-α):

        s' = (α·q̂)·x̂ᵀ - c1·min(|Δλ|, 1)      (true score = s' + c1)

    α rides inside the prescaled query so the matmul emits α·cos in one
    pass; this is a rank-preserving reassociation of the reference
    expression α·cos + (1-α)·(1-min(|Δλ|,1)) (core.rs:135-175).  At α=1,
    c1=0 and the plane is exactly the cosine.  Top-k callers sort on s'
    and restore +c1 on the returned scores only.  The dot is
    ``score_dot`` (HIGHEST, or bf16 operands with f32 accumulation)."""
    a = jnp.asarray(alpha, queries.dtype)
    c1 = 1.0 - a
    return _shifted_block(_safe_unit(queries) * a, query_lambdas, items,
                          item_lambdas, c1, use_bf16), c1


def _shifted_block(qa, query_lambdas, x, lam, c1, use_bf16=False):
    """s' of prescaled queries qa = α·q̂ against rows x (see
    _shifted_lambda_plane)."""
    acos = score_dot(qa, _safe_unit(x), use_bf16)
    dl = jnp.abs(query_lambdas[:, None] - lam[None, :])
    return acos - c1 * jnp.minimum(dl, 1.0)


@jax.jit
def lambda_aware_scores(
    queries: jax.Array,       # (B, F)
    query_lambdas: jax.Array,  # (B,)
    items: jax.Array,          # (N, F)
    item_lambdas: jax.Array,   # (N,)
    alpha: jax.Array,          # scalar
) -> jax.Array:
    """score = α·cos + (1-α)·(1 - min(|Δλ|, 1))  (core.rs:135-175),
    computed via the canonical shifted form (see _shifted_lambda_plane)
    so every score plane shares one arithmetic."""
    shifted, c1 = _shifted_lambda_plane(queries, query_lambdas, items,
                                        item_lambdas, alpha)
    return shifted + c1


def lambda_topk(queries, query_lambdas, items, item_lambdas, alpha, *,
                k: int, n_live=None, use_bf16: bool = False,
                chunk: int = 0):
    """THE λ-aware top-k step (unjitted, so session steps, mesh shards
    and the jitted wrapper below all trace the same code).

    Sorts on the shifted plane (_shifted_lambda_plane) and restores +c1
    on the returned scores.  The plane is bounded by SCORE_PLANE_BYTES
    (chunk=0 derives the chunk from it; a positive chunk overrides it):
    past the budget the corpus is scanned in row chunks by scan_topk, so
    a B=2048 batch over 10M rows never materialises the 84 GB plane.
    `n_live` masks the rows of a capacity-padded live corpus.  Ties
    resolve to the lowest index.

    use_bf16 scores the plane with bf16 operands and f32 accumulation,
    keeps its top BF16_POOL·k candidates, and rescores those exactly at
    Precision.HIGHEST: returned scores are f32-exact, and the result
    differs from the f32 path only where a true top-k row falls outside
    the bf16 pool.  Returns (scores (B, k), ids (B, k))."""
    b = queries.shape[0]
    n, f = items.shape
    dt = queries.dtype
    a = jnp.asarray(alpha, dt)
    c1 = 1.0 - a
    qa = _safe_unit(queries) * a

    def score_rows(start, rows):
        if rows == n:
            x, lam = items, item_lambdas
        else:
            x = jax.lax.dynamic_slice(items, (start, 0 * start),
                                      (rows, f))
            lam = jax.lax.dynamic_slice(item_lambdas, (start,), (rows,))
        return _shifted_block(qa, query_lambdas, x, lam, c1, use_bf16)

    k_scan = min(n, BF16_POOL * k) if use_bf16 else k
    chunk = chunk or plane_chunk_rows(b, n, k_scan)
    s, i = scan_topk(score_rows, n, b, k_scan, min(max(chunk, k_scan), n),
                     dt, n_live=n_live)
    if use_bf16:
        s, i = _rescore_exact(qa, query_lambdas, items, item_lambdas, c1, i,
                              k, n_live)
    # -inf masked slots (n_live < k) stay -inf through the restore
    return s + c1, i


def _rescore_exact(qa, query_lambdas, items, item_lambdas, c1, cand, k,
                   n_live):
    """Exact shifted scores of candidate ids (B, m) at Precision.HIGHEST,
    then the top k with ties to the lowest id (a two-key sort)."""
    x = _safe_unit(items[cand])                          # (B, m, F)
    acos = jnp.einsum("bf,bmf->bm", qa, x, precision=HIGHEST,
                      preferred_element_type=qa.dtype)
    dl = jnp.abs(query_lambdas[:, None] - item_lambdas[cand])
    s = acos - c1 * jnp.minimum(dl, 1.0)
    if n_live is not None:
        s = jnp.where(cand < n_live, s, -jnp.inf)
    neg, ids = jax.lax.sort((-s, cand), num_keys=2, dimension=1)
    return -neg[:, :k], ids[:, :k]


batched_lambda_aware_topk = jax.jit(
    lambda_topk, static_argnames=("k", "use_bf16", "chunk"))
batched_lambda_aware_topk.__doc__ = (
    "Jitted lambda_topk: (B, F) queries -> (scores (B, k), ids (B, k)).")


@functools.partial(jax.jit, static_argnames=("k",))
def hybrid_search_device(
    query: jax.Array,        # (F,)
    query_lambda: jax.Array,  # scalar
    items: jax.Array,
    item_lambdas: jax.Array,
    alpha: jax.Array,
    *,
    k: int,
):
    """Device part of search_lambda_aware_hybrid (core.rs:802-928):
    λ-aware top-k, cosine top-1, and the high-cosine mask (> 0.9999).
    Kept for callers that want the raw components; the serving path uses
    hybrid_search_device_fused (O(k) fetch instead of O(N))."""
    cos = cosine_scores(query[None, :], items)[0]
    dl = jnp.abs(query_lambda - item_lambdas)
    lam_score = alpha * cos + (1.0 - alpha) * (1.0 - jnp.minimum(dl, 1.0))
    top_scores, top_idx = jax.lax.top_k(lam_score, k)
    sem_idx = jnp.argmax(cos)
    high_mask = cos > 0.9999
    return top_scores, top_idx, sem_idx, cos, high_mask


@functools.partial(jax.jit, static_argnames=("k",))
def hybrid_search_device_fused(
    query: jax.Array,        # (F,)
    query_lambda: jax.Array,  # scalar
    items: jax.Array,
    item_lambdas: jax.Array,
    alpha: jax.Array,
    *,
    k: int,
):
    """Fully device-side hybrid union (core.rs:802-928): the union +
    dedup + precedence of the reference's fold/reduce — high-cosine
    matches keep their cosine score, λ-top-k entries their blended
    score, the semantic top-1 its cosine — expressed as one effective
    score per item, so the final top-k is ONE lax.top_k and the host
    fetches O(k) bytes instead of the full (N,) cosine array.

    Precedence mirrors the host dict's insertion order: high-cos beats
    λ-top-k membership beats semantic-top-1; items in none of the three
    sets are excluded (-inf).  The λ-top-k contributes k entries, so the
    result always holds k valid rows for k <= N."""
    cos = cosine_scores(query[None, :], items)[0]
    dl = jnp.abs(query_lambda - item_lambdas)
    lam_score = alpha * cos + (1.0 - alpha) * (1.0 - jnp.minimum(dl, 1.0))
    _, top_idx = jax.lax.top_k(lam_score, k)
    n = items.shape[0]
    in_topk = jnp.zeros((n,), jnp.bool_).at[top_idx].set(True)
    sem_idx = jnp.argmax(cos)
    high = cos > 0.9999
    is_sem = jnp.arange(n) == sem_idx
    neg_inf = jnp.asarray(-jnp.inf, dtype=cos.dtype)
    eff = jnp.where(high, cos,
                    jnp.where(in_topk, lam_score,
                              jnp.where(is_sem, cos, neg_inf)))
    return jax.lax.top_k(eff, k)
