"""The benchmark of gan_tpu_torch: one run of one cell is
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(README.md beside this file)."""
