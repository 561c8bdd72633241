"""The benchmark of pose_tpu_torch (the PyTorch and CUDA port): run with
`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout, on a machine with the cards
the cell asks for (BENCHMARK.json)."""
