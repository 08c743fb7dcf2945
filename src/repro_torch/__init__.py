"""PyTorch/CUDA port of the DBL reachability index (``repro`` is the JAX
reference).

The port mirrors ``repro``'s layout module by module.  It imports torch and
numpy only.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; the label kernels (``kernels/csrc``: the verdicts and the
BFS admit plane, each as a grid kernel and a streamed one) are hand-written
CUDA C++ for Hopper and run only on CUDA tensors, while CPU tensors take
their plain PyTorch versions.
"""
