"""The benchmark of the PyTorch/CUDA port (sbsim_tpu_torch): one run of one
cell with `python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`; cells, metrics and bounds in BENCHMARK.json."""
