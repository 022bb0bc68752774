"""Free Join on PyTorch and CUDA: the port of the `repro` package.

`repro_torch.core.compiled_free_join` runs a conjunctive query end to end
on an NVIDIA H100 (or, for tests, on the CPU with `ExecOptions(device=
"cpu")`): cost-based plan choice, capacity planning, cached tries built
with a segmented radix sort, and the expand / probe / compact executor,
with the hash probe, the CSR expansion, the frontier compaction and the
radix rank as hand-written CUDA kernels (repro_torch/kernels/csrc).
"""
