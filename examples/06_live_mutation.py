"""Live index mutation at serving time: add / update / delete, zero
recompiles.

No reference analogue (the reference's ArrowSpace is mutable —
core.rs:614-727 — but has no serving runtime around it); this shows the
deployment shape of a MUTABLE index:

1. build an index once, open a LiveSearchSession sized for the
   deployment's ceiling (capacity) — the corpus lives in a
   capacity-padded device buffer and the true row count rides to the
   kernels as DATA, so none of the mutations below retrace or recompile
   anything;
2. add new vectors (λ assigned by the standard preparation pipeline
   against the frozen build graph — the same trade the reference's λ
   maintenance makes), update rows in place, delete by stable external
   id (swap-with-last compaction);
3. keep serving throughout — every search scores exactly the current
   live rows;
4. snapshot with to_index() for persistence or a periodic full graph
   rebuild.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from arrowspace_tpu import init
from arrowspace_tpu.index import ArrowIndex


def main():
    init()
    rng = np.random.default_rng(11)
    n, f = 20_000, 64
    centers = rng.uniform(0.2, 0.8, (32, f))
    rows = centers[rng.integers(0, 32, n)] + rng.normal(0, 0.1, (n, f))

    t0 = time.time()
    idx = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=3)
    print(f"build: {idx.nitems} items in {time.time() - t0:.2f}s")

    live = idx.make_live_session(batch_size=64, k=10, alpha=0.9,
                                 capacity=32_000)
    live.warmup()
    print(f"live session: capacity {live.capacity}, n={live.nitems}")

    # -- ingest a fresh batch of vectors -------------------------------
    fresh = centers[rng.integers(0, 32, 500)] + rng.normal(
        0, 0.1, (500, f))
    t0 = time.time()
    ids = live.add(fresh)
    print(f"add 500 rows: {time.time() - t0:.3f}s "
          f"(ids {ids[0]}..{ids[-1]}, n={live.nitems})")

    # the new rows are immediately searchable
    s, got = live.search(fresh[:4] * 1.01)
    assert all(got[i][0] == ids[i] for i in range(4))
    print("new rows rank first for their own perturbations")

    # -- update: move a vector; its λ refreshes like set_item ----------
    target = fresh[100] * -1.0 + 1.0
    live.update([int(ids[100])], target[None])
    _, got = live.search(target * 1.005)
    assert got[0][0] == ids[100]
    print("updated row found at its new location")

    # -- delete by stable id; results never contain deleted ids --------
    doomed = [int(ids[0]), 17, 4242]
    live.delete(doomed)
    _, got = live.search(np.concatenate([fresh[:2], rows[:2]]) * 1.01)
    assert not set(doomed) & set(got.ravel().tolist())
    print(f"deleted {doomed}; n={live.nitems}, ids stable for survivors")

    # -- snapshot for persistence / periodic graph rebuild -------------
    snap, ext_ids = live.to_index()
    print(f"snapshot: {snap.nitems} rows; row j carries external id "
          f"ext_ids[j] (e.g. ext_ids[0]={ext_ids[0]})")


if __name__ == "__main__":
    main()
