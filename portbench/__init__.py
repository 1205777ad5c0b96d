"""portbench: the benchmark of citus_tpu_torch, the PyTorch/CUDA port.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card it finds and
prints one JSON line.  Everything that belongs to one configuration,
traffic mix, query or per-layer metric is a file of its own, found by
the name BENCHMARK.json gives it:

  configs/<config>.json      the deployment: scale, layout, settings
  traffic/<mix>.json         sessions, loop and the queries' weights
  queries/<query>.sql        the statement text, frozen
  reference/<query>.py       its plain evaluation and comparison
  end_to_end/<metric>.py     one reader per end-to-end metric
  layer_metrics/<metric>.py  one reader per per-layer metric
  datagen/tpch_gen.py        the TPC-H generator, frozen

Nothing here imports JAX or the JAX package `citus_tpu`; the reference
imports nothing of the port either.
"""
