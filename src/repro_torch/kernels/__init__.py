"""The device kernels and the op layer around them.

hash_probe (K1), csr_expand (K2), compact (K3), radix_sort's radix_rank
(K4), intersect (K5) and seg_scan (the trie build's scans) each hold a
CUDA wrapper, its plain PyTorch version and a launch counter; ops.py
prepares their inputs; ref.py holds brute-force oracles; _build.py
compiles csrc/*.cu at first use.
"""
