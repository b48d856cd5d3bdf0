"""The benchmark of the PyTorch and CUDA annealing package
(``src/repro_torch``): ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.
``BENCHMARK.json`` at the root names the cells; everything else is found
by name under this folder (see ``lib/cells.py``)."""
