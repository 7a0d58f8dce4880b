"""Low-latency exact serving: the cell-screened (pruned) session.

No reference analogue (the reference full-scans every query,
core.rs:760-798); this is the low-latency path on top of the
same scoring semantics:

1. build an index once;
2. open a PrunedSearchSession — the corpus is grouped into ≤cap-row
   cells with spherical-cap score upper bounds; a query exact-scores
   only the cells whose bound can reach its top-k, and queries the
   bounds cannot CERTIFY transparently re-run through the full scan,
   so every returned row equals the full scan's (exactness is never
   traded);
3. auto_budget=True lets the session widen its own screening budget
   when serving traffic drifts and the flag rate rises (growth-only,
   capped where gathered rows approach the corpus stream's cost);
4. at multi-GB corpus scale, build the cell layout fully on device
   (engine="device" / pruned.build_cells_device) and OVERSAMPLE the
   cluster count 2-4x the corpus's real cluster count (the
   provisioning rule in build_cells's docstring).

A full scan pays the whole corpus read at any batch size; the screen's
gather is N-independent, so the gap grows with N (PERF.md has the
measured times).

Run on CPU:
  python -c "import jax; jax.config.update('jax_platforms','cpu'); \
             import runpy; runpy.run_path('08_pruned_lowlat.py', \
             run_name='__main__')"
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> None:
    from arrowspace_tpu.config import setup_cache
    setup_cache()
    from arrowspace_tpu import ArrowIndex

    rng = np.random.default_rng(3)
    n, f, centers = 60_000, 64, 48
    cents = rng.uniform(0.2, 0.8, (centers, f))
    rows = cents[rng.integers(0, centers, n)] \
        + rng.normal(0, 0.03, (n, f))

    t0 = time.time()
    idx = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11)
    print(f"index build {n}x{f}: {time.time() - t0:.1f}s")

    # --- the latency session -----------------------------------------
    sess = idx.make_pruned_session(batch_size=16, k=10, alpha=0.9,
                                   cap=128, auto_budget=True)
    sess.warmup()          # compile step + fallback: serving is
    #                        dispatch-only from here

    # hot traffic: perturbed corpus rows (the common serving shape)
    for step in range(4):
        queries = rows[rng.integers(0, n, 16)] * 1.01
        t0 = time.time()
        scores, ids = sess.search(queries)
        dt = time.time() - t0
        print(f"batch {step}: {dt * 1e3:6.1f} ms  "
              f"(certified so far: "
              f"{1.0 - sess.flag_rate:.2%} of {sess.queries_total})")

    # every session row equals the full scan — spot-check one batch
    queries = rows[rng.integers(0, n, 16)] * 1.01
    sp, ip = sess.search(queries)
    so, io = idx.search(queries, k=10, alpha=0.9)
    agree = sum(1 for b in range(16)
                if list(ip[b]) == list(np.asarray(io)[b]))
    print(f"session vs full search: {agree}/16 identical id lists "
          f"(flagged rows fall back to the full scan, so agreement "
          f"is by construction; f32 near-ties may permute between "
          f"the two APIs — see docs/SERVING.md)")

    # adversarial traffic: bounds go vacuous on uniform data — the
    # session FLAGS and serves through the fallback, never wrong
    adv = rng.normal(size=(16, f))
    sess.search(adv)
    print(f"after an adversarial batch: flag rate "
          f"{sess.flag_rate:.2%}, budget growths "
          f"{sess.budget_growths} (auto_budget widens the screen only "
          f"if the drift persists)")


if __name__ == "__main__":
    main()
