"""One module per metric of `BENCHMARK.json`, named as the metric: its
`read(run)` returns the value, or None where the run holds nothing to read
(the harness then leaves the metric out).  `run` is `zkbench.run.Run`."""
