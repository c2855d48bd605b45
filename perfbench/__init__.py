"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): the
harness, its data files, its plain reference and its readers.  Run it as
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
