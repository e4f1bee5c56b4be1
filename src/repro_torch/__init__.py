"""The PyTorch and CUDA port of ``repro`` (ENDURE / K-LSM) for NVIDIA H100.

- core/      cost model and the batched nominal / robust tuners
- lsm/       the LSM engine with device arenas, and its session runner
- kernels/   the CUDA kernels' wrappers (ops.py) and plain versions (ref.py)
- csrc/      the CUDA C++ sources, built on first use by kernels/_build.py
- convert.py carries the JAX package's state across as numpy arrays
- quickstart.py the paper's pipeline end to end

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
