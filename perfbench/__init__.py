"""Benchmark of the PyTorch and CUDA port (``hipporag_tpu_torch``); run one
cell with ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Nothing here imports JAX or the JAX
package."""
