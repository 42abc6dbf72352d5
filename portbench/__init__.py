"""The benchmark of the PyTorch / CUDA port (`contextual_image_compression_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once on the card and prints one JSON line. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own under `configs/`, `traffic/`, `workloads/`, `metrics/` and
`work/`, found by name; `harness/` is the general code and `reference/`
the plain PyTorch reference that decides `correct`.
"""
