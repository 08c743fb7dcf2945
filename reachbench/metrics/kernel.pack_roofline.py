"""kernel.pack_roofline: the label-plane pack kernel's summed bound over
its summed device time in the window, in percent.  One
``repro_torch::pack_label_planes`` call packs the planes (n_cap, k),
(n_cap, k), (n_cap, k'), (n_cap, k') into int32 words: each plane byte is
read once and each word written once, and its few operations a word lie
far below that byte bound."""
from reachbench.bounds import bound_s
from reachbench.readers import _dims, roofline


def _words(k: int) -> int:
    return -(-k // 32)


def pack_bound(shapes) -> float:
    n_cap, k = _dims(shapes, 0)
    kp = _dims(shapes, 2)[1]
    nbytes = n_cap * (2 * k + 2 * kp) \
        + 4 * n_cap * (2 * _words(k) + 2 * _words(kp))
    return bound_s(nbytes, 0)


def read(run):
    return roofline(run, "repro_torch::pack_label_planes",
                    "pack_planes_kernel", pack_bound)
