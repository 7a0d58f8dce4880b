"""LiveSearchSession: zero-recompile add / update / delete serving.

Oracles are brute-force NumPy over the CURRENT live rows (f64 on the CPU
backend), with λ values derived through the same public preparation API
the session mirrors (prepare_query_items_batch) — an independent host
path from the session's jitted ingest program.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from arrowspace_tpu.index import ArrowIndex
from arrowspace_tpu.live import LiveSearchSession
from data import make_moons_hd


def _index(n=80, dims=12, seed=42):
    rows = make_moons_hd(n, noise=0.08, hd_noise=0.04, dims=dims, seed=1)
    return rows, ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3,
                                  seed=seed)


def _oracle_topk(queries, qlam, rows, lams, alpha, k):
    """Brute-force λ-aware top-k with lax.top_k tie order (desc score,
    asc index)."""
    q = np.asarray(queries, dtype=np.float64)
    x = np.asarray(rows, dtype=np.float64)
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    xn = np.linalg.norm(x, axis=1, keepdims=True)
    qh = np.where(qn > 0, q / np.where(qn > 0, qn, 1.0), 0.0)
    xh = np.where(xn > 0, x / np.where(xn > 0, xn, 1.0), 0.0)
    cos = qh @ xh.T
    dl = np.abs(np.asarray(qlam)[:, None] - np.asarray(lams)[None, :])
    sc = alpha * cos + (1.0 - alpha) * (1.0 - np.minimum(dl, 1.0))
    out_s = np.empty((q.shape[0], k))
    out_i = np.empty((q.shape[0], k), dtype=np.int64)
    for b in range(q.shape[0]):
        order = np.lexsort((np.arange(sc.shape[1]), -sc[b]))[:k]
        out_s[b], out_i[b] = sc[b][order], order
    return out_s, out_i


def _live_oracle(idx, sess_added_rows):
    """(rows, lams) of the live corpus = originals + added rows with λ
    from the public preparation API."""
    rows = [np.asarray(idx.aspace.host_rows, dtype=np.float64)]
    lams = [np.asarray(idx.lambdas, dtype=np.float64)]
    if len(sess_added_rows):
        added = np.asarray(sess_added_rows, dtype=np.float64)
        rows.append(added)
        lams.append(np.asarray(
            idx.aspace.prepare_query_items_batch(added, idx.gl)))
    return np.concatenate(rows, axis=0), np.concatenate(lams)


def test_add_then_search_exact_oracle_parity():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=8, k=5, alpha=0.9,
                                 capacity=200)
    rng = np.random.default_rng(7)
    new_rows = rng.uniform(0.1, 1.0, (10, rows.shape[1]))
    new_ids = sess.add(new_rows)
    assert list(new_ids) == list(range(80, 90))
    assert sess.nitems == 90

    queries = np.concatenate([rows[:2] * 1.01, new_rows[:2] * 1.01])
    s, ids = sess.search(queries)
    o_rows, o_lams = _live_oracle(idx, new_rows)
    qlam = np.asarray(idx.aspace.prepare_query_items_batch(queries, idx.gl))
    os_, oi = _oracle_topk(queries, qlam, o_rows, o_lams, 0.9, 5)
    np.testing.assert_allclose(s, os_, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ids, oi)   # positions == ids pre-delete
    # the added rows are findable: their own perturbation ranks them first
    assert ids[2][0] == 80 and ids[3][0] == 81


def test_added_lambda_matches_core_refresh_semantics():
    """Ingest λ must equal what core.set_item + _refresh_lambda_row
    assigns (the reference's λ maintenance, core.rs:614-727)."""
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=200)
    new_row = np.abs(np.sin(np.arange(rows.shape[1]) + 1.0)) + 0.05
    (nid,) = sess.add(new_row)
    lam_live = float(np.asarray(sess._lam[sess._pos[int(nid)]]))

    from arrowspace_tpu.taumode import select_tau, synthetic_lambda_single
    tau = select_tau(new_row, idx.aspace.taumode)
    lam_core = synthetic_lambda_single(
        jnp.asarray(new_row, dtype=idx.gl.matrix.dtype), idx.gl.matrix, tau)
    assert abs(lam_live - float(lam_core)) < 1e-12


def test_update_refreshes_lambda_and_scores():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=5, capacity=200)
    new_vec = np.roll(rows[10], 3) + 0.2
    sess.update([5], new_vec[None, :])
    # λ refreshed like set_item + _refresh_lambda_row
    from arrowspace_tpu.taumode import select_tau, synthetic_lambda_single
    tau = select_tau(new_vec, idx.aspace.taumode)
    lam_exp = synthetic_lambda_single(
        jnp.asarray(new_vec, dtype=idx.gl.matrix.dtype), idx.gl.matrix, tau)
    assert abs(float(np.asarray(sess._lam[5])) - float(lam_exp)) < 1e-12
    # searching the new vector finds id 5 first
    s, ids = sess.search(new_vec * 1.01)
    assert ids[0][0] == 5
    # oracle parity over the mutated corpus
    o_rows = np.asarray(idx.aspace.host_rows, dtype=np.float64).copy()
    o_rows[5] = new_vec
    o_lams = np.asarray(idx.lambdas, dtype=np.float64).copy()
    o_lams[5] = float(lam_exp)
    q = np.atleast_2d(new_vec * 1.01)
    qlam = np.asarray(idx.aspace.prepare_query_items_batch(q, idx.gl))
    os_, oi = _oracle_topk(q, qlam, o_rows, o_lams, 0.9, 5)
    np.testing.assert_allclose(s, os_, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ids, oi)


def test_delete_swap_compaction_and_stable_ids():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=5, capacity=200)
    rng = np.random.default_rng(3)
    added = rng.uniform(0.1, 1.0, (5, rows.shape[1]))
    aids = sess.add(added)                       # ids 80..84
    sess.delete([2, 40, 83])                     # two originals, one added
    assert sess.nitems == 82

    # deleted ids never come back; surviving added rows stay findable
    s, ids = sess.search(added[4] * 1.01)
    assert ids[0][0] == aids[4]
    assert not {2, 40, 83} & set(ids.ravel().tolist())

    # full oracle over the survivor set (order-independent: compare the
    # retrieved (id, score) pairs against the survivor brute force)
    o_rows, o_lams = _live_oracle(idx, added)
    keep = np.array([j for j in range(85) if j not in (2, 40, 83)])
    q = np.atleast_2d(added[4] * 1.01)
    qlam = np.asarray(idx.aspace.prepare_query_items_batch(q, idx.gl))
    os_, oi = _oracle_topk(q, qlam, o_rows[keep], o_lams[keep], 0.9, 5)
    np.testing.assert_allclose(s, os_, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ids[0], keep[oi[0]])


def test_delete_then_add_reuses_slots():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=200)
    sess.delete(list(range(70, 80)))
    assert sess.nitems == 70
    rng = np.random.default_rng(11)
    new_ids = sess.add(rng.uniform(0.1, 1.0, (15, rows.shape[1])))
    assert sess.nitems == 85
    assert list(new_ids) == list(range(80, 95))   # ids never recycled


def test_capacity_enforced_and_grow():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=100)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="live corpus full"):
        sess.add(rng.uniform(0.1, 1.0, (30, rows.shape[1])))
    sess.grow(150)
    ids = sess.add(rng.uniform(0.1, 1.0, (30, rows.shape[1])))
    assert len(ids) == 30 and sess.nitems == 110
    s, out = sess.search(rows[:2])
    assert s.shape == (2, 3)


def test_stream_sees_mutations_between_batches():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=5, capacity=200)
    rng = np.random.default_rng(9)
    marker = rng.uniform(0.4, 0.6, (1, rows.shape[1]))

    q = marker * 1.01

    def batches():
        yield q
        (mid,) = sess.add(marker)
        batches.mid = mid
        yield q

    outs = list(sess.search_stream(batches()))
    # depth=2 keeps batches in flight, but the second dispatch happens
    # after add() ran, so the marker appears in the second result only
    # if its dispatch followed the mutation — with depth 2 both batches
    # may dispatch first; accept either for batch 1, require the final
    # sync search to see it.
    s, ids = sess.search(q)
    assert ids[0][0] == batches.mid
    assert len(outs) == 2


def test_unknown_id_errors():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=120)
    with pytest.raises(KeyError, match="unknown or deleted external id"):
        sess.delete([999])
    (nid,) = sess.add(rows[0][None, :] * 1.1)
    sess.delete([nid])
    with pytest.raises(KeyError, match="unknown or deleted"):
        sess.update([nid], rows[0][None, :])


def test_warmup_and_empty_add():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=120)
    sess.warmup()
    assert sess.nitems == 80
    assert sess.add(np.empty((0, rows.shape[1]))).shape == (0,)


def test_warmup_sweeps_mutation_buckets_and_compacting_delete():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=120)
    sess.warmup(mutation_buckets=(1, 2, 4))
    # probes must leave the corpus exactly as it was
    assert sess.nitems == 80
    s, i = sess.search(rows[3][None, :])
    assert i[0, 0] < 80  # no probe-row ghosts in results
    # a bucket that doesn't fit remaining capacity is skipped, not an error
    sess.warmup(mutation_buckets=(4096,))
    assert sess.nitems == 80


def test_update_duplicate_ids_raise():
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=3, capacity=120)
    with pytest.raises(ValueError, match="duplicate external ids"):
        sess.update([5, 5], np.stack([rows[0], rows[1]]))
    with pytest.raises(ValueError, match="ids but"):
        sess.update([5], np.stack([rows[0], rows[1]]))


def test_k_clamps_to_capacity_not_initial_size():
    # seed from a small index with headroom: k must survive growth
    rows = make_moons_hd(24, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=42)
    sess = idx.make_live_session(batch_size=4, k=30, capacity=200)
    assert sess.k == 30  # NOT clamped to the initial 24
    with pytest.raises(ValueError, match="exceeds the live corpus size"):
        sess.search(rows[0][None, :])
    rng = np.random.default_rng(7)
    sess.add(rng.uniform(0.1, 1.0, (10, rows.shape[1])))
    s, i = sess.search(rows[0][None, :])
    assert s.shape == (1, 30) and len(set(i[0].tolist())) == 30


def test_search_below_k_after_delete_raises_not_assert():
    rows = make_moons_hd(12, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    idx = ArrowIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=42)
    sess = idx.make_live_session(batch_size=4, k=10, capacity=64)
    sess.delete(list(range(5)))  # live count 7 < k=10
    with pytest.raises(ValueError, match="exceeds the live corpus size"):
        sess.search(rows[0][None, :])
    with pytest.raises(ValueError, match="exceeds the live corpus size"):
        next(iter(sess.search_stream([rows[:4]])))


def test_snapshot_to_index_roundtrip(tmp_path):
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=5, capacity=200)
    rng = np.random.default_rng(5)
    added = rng.uniform(0.1, 1.0, (6, rows.shape[1]))
    sess.add(added)
    sess.delete([0, 81])
    snap, ext_ids = sess.to_index()
    assert snap.nitems == sess.nitems == 84
    assert len(ext_ids) == 84 and len(set(ext_ids.tolist())) == 84

    # snapshot search == live search (ids mapped through ext_ids)
    q = added[3] * 1.02
    s_live, i_live = sess.search(q)
    s_snap, i_snap = snap.search(np.atleast_2d(q), k=5, alpha=0.9)
    np.testing.assert_allclose(s_live, s_snap, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(i_live[0], ext_ids[i_snap[0]])

    # persists through the standard Parquet artifacts
    snap.save(tmp_path, "live-snap")
    back = ArrowIndex.load(tmp_path, "live-snap")
    np.testing.assert_allclose(back.lambdas, snap.lambdas, rtol=1e-12)


def _energy_index():
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams, build_energy
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 400)] + rng.normal(
        0, 0.02, (400, 16))
    b = (ArrowSpaceBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    return rows, ArrowIndex(aspace, gl, b)


def _energy_z(idx, rows_raw):
    """Host-side mirror of the session's z transform for raw F-dim rows:
    project (public API) then apply the signals map."""
    a = idx.aspace
    r = np.asarray(rows_raw, dtype=np.float64)
    if a.projection_matrix is not None:
        r = a.projection_matrix.project_batch_host(r)
    sig = np.asarray(a.signals) if a.signals is not None else None
    if sig is not None and sig.shape[0] > 0 and sig.shape[1] == r.shape[1]:
        return r @ sig.T
    return r


def _energy_oracle(z_q, qlam, z_x, xlam, wl, wd, k):
    d = np.sqrt(np.maximum(
        (z_q * z_q).sum(1)[:, None] - 2.0 * z_q @ z_x.T
        + (z_x * z_x).sum(1)[None, :], 0.0))
    d_dir = np.minimum(d / (1.0 + d), 1.0)
    d_lam = np.abs(np.asarray(qlam)[:, None] - np.asarray(xlam)[None, :])
    sc = -(wl * d_lam + wd * d_dir)
    out_s = np.empty((z_q.shape[0], k))
    out_i = np.empty((z_q.shape[0], k), dtype=np.int64)
    for b in range(z_q.shape[0]):
        order = np.lexsort((np.arange(sc.shape[1]), -sc[b]))[:k]
        out_s[b], out_i[b] = sc[b][order], order
    return out_s, out_i


def test_live_energy_pre_mutation_matches_static_api():
    rows, idx = _energy_index()
    sess = idx.make_live_energy_session(batch_size=8, k=5, capacity=600)
    q = rows[:8] * 1.01
    s_live, i_live = sess.search(q)
    s_ref, i_ref = idx.search_energy(q, k=5, w_lambda=1.0,
                                     w_dirichlet=0.5)
    np.testing.assert_array_equal(i_live, i_ref)
    np.testing.assert_allclose(s_live, s_ref, rtol=1e-9)


def test_live_energy_add_delete_oracle_parity():
    rows, idx = _energy_index()
    sess = idx.make_live_energy_session(batch_size=8, k=5, capacity=600)
    rng = np.random.default_rng(13)
    added = rng.uniform(0.0, 1.0, (7, rows.shape[1]))
    aids = sess.add(added)
    sess.delete([3, int(aids[2])])
    assert sess.nitems == 405

    q = np.concatenate([rows[:2] * 1.01, added[:1] * 1.01])
    s, ids = sess.search(q)

    # independent host oracle over the live survivor set
    z_all = np.concatenate([_energy_z(idx, rows), _energy_z(idx, added)])
    lam_all = np.concatenate([
        np.asarray(idx.lambdas, dtype=np.float64),
        np.asarray(idx.aspace.prepare_query_items_batch(added, idx.gl))])
    keep = np.array([j for j in range(407) if j not in (3, 402)])
    z_q = _energy_z(idx, q)
    qlam = np.asarray(idx.aspace.prepare_query_items_batch(q, idx.gl))
    os_, oi = _energy_oracle(z_q, qlam, z_all[keep], lam_all[keep],
                             1.0, 0.5, 5)
    np.testing.assert_allclose(s, os_, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ids, keep[oi])
    assert not {3, 402} & set(ids.ravel().tolist())



@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_add", [1, 7, 40])
def test_live_step_after_adds_matches_oracle(precision, n_add):
    """One compiled live step serves every live count: after adding
    n_add rows the session equals the f64 oracle over the live rows
    (bf16: the self-match stays first and scores agree to bf16
    rounding)."""
    rows, idx = _index()
    sess = idx.make_live_session(batch_size=4, k=5, alpha=0.9,
                                 capacity=160, precision=precision)
    rng = np.random.default_rng(n_add)
    added = rows[rng.choice(80, n_add, replace=False)] * 1.3 + 0.01
    sess.add(added)
    q = added[-2:] * 1.001
    s, ids = sess.search(q)
    all_rows, lams = _live_oracle(idx, added)
    qlam = np.asarray(idx.aspace.prepare_query_items_batch(q, idx.gl))
    so, io = _oracle_topk(q, qlam, all_rows, lams, 0.9, 5)
    if precision == "f32":
        np.testing.assert_array_equal(ids, io)
        np.testing.assert_allclose(s, so, rtol=1e-9)
    else:
        # bf16 rounding (~4e-3) can reorder near-parallel rows; the sets
        # overlap and the scores agree to bf16 rounding
        for got, want in zip(ids, io):
            assert len(set(got) & set(want)) >= 3
        np.testing.assert_allclose(s, so, atol=2e-2)
