"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their
wrappers.

- dbl_query: fused label verdicts (Alg 2 lines 6-13)
- bfs_prune: the BFS admit plane (Alg 2 lines 20/22)

Each comes as a grid kernel and a streamed one (persistent blocks with a
two-stage cp.async ring, ``streaming=True`` in the ops wrappers).

A wrapper launches its kernel for CUDA tensors and takes the kernel's plain
PyTorch version for CPU tensors; nothing falls back from one to the other.
"""
