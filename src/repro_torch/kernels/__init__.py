"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their
wrappers.

- dbl_query: fused label verdicts (Alg 2 lines 6-13)
- bfs_prune: the BFS admit plane (Alg 2 lines 20/22)
- pack_planes: the four 0/1 label planes packed into int32 words, in one
  launch (``core.query.pack_labels``)
- bfs_relax: one level of the batched BFS (``core.query.relax``), with no
  host read

The first two each come as a grid kernel and a streamed one (persistent
blocks with a two-stage cp.async ring, ``streaming=True`` in the ops
wrappers).

Each kernel is a torch custom op under the ``repro_torch`` namespace
(``dbl_query_verdicts``, ``dbl_query_verdicts_streamed``,
``bfs_admit_plane``, ``bfs_admit_plane_streamed``, ``pack_label_planes``,
``bfs_relax``),
registered when this package is imported, so that a process loading an
exported program finds them.  An op launches its kernel for CUDA tensors and runs the kernel's
plain PyTorch version for CPU tensors; nothing falls back from one to the
other.
"""
from .dbl_query import dbl_query as _dbl_query  # noqa: F401  (registers)
from .bfs_prune import bfs_prune as _bfs_prune  # noqa: F401  (registers)
from .pack_planes import pack_planes as _pack_planes  # noqa: F401  (registers)
from .bfs_relax import bfs_relax as _bfs_relax  # noqa: F401  (registers)
from .dbl_query.ops import query_verdicts  # noqa: F401
from .bfs_prune.ops import admit_plane  # noqa: F401
