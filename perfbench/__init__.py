"""The port's benchmark: one cell (a model configuration under a traffic
mix) a run, `python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`.  Configurations, mixes, drivers and
per-layer metrics are files found by name (see `harness`)."""
