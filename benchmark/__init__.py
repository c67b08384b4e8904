"""The benchmark of the PyTorch / CUDA port (`lmdx_torch`): run one cell with
`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`."""
