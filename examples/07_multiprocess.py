"""Multi-process (multi-host) build and serving.

No reference analogue — the reference (arrowspace-rs) is strictly
single-process (its only parallelism is rayon shared-memory fan-out);
this layer exists for corpora that exceed one host, e.g. the
100M x 768 target (SURVEY.md section 5).

The execution model (parallel/multiprocess.py):

1. ONE driver process per host calls ``init_distributed(coordinator,
   num_processes, process_id)``; after that, ``jax.devices()`` is the
   GLOBAL device list and every jitted program in the package runs
   SPMD across hosts (XLA collectives within and between hosts).
2. Each host ingests ONLY its row slice (``local_row_range`` +
   ``make_sharded_corpus``) — no host ever materialises the full
   corpus (~300 GB at 100M x 768).
3. Builds must be SEEDED: all hosts apply the same deterministic host
   rules to bit-identical replicated reductions and stay in lockstep
   with no coordination beyond jax.distributed itself.
4. Serving sessions (DistributedSearchSession / the energy variant)
   work unchanged: per-shard top-k + a hierarchical merge that sends
   only k candidates per host across hosts.

On a real cluster you run this file once per host with the coordinator
address and process id set by your launcher.  This demo instead runs
the whole thing on THIS machine: it spawns 2 localhost worker
processes x 4 virtual CPU devices each (gloo collectives) through the
same code path (parallel/mp_worker.py) and prints process 0's results.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from arrowspace_tpu.parallel.multiprocess import \
        run_cpu_multiprocess_dryrun

    print("launching 2 localhost processes x 4 virtual CPU devices ...",
          flush=True)
    res = run_cpu_multiprocess_dryrun(num_processes=2, local_devices=4,
                                      n_rows=65536, f=64)
    print("process 0 reports:")
    for key, val in res.items():
        print(f"  {key}: {val}")
    assert res.get("process_count") == 2
    assert res.get("ok"), res
    print("\nmulti-process sharded build -> query -> serve: OK")


if __name__ == "__main__":
    main()
