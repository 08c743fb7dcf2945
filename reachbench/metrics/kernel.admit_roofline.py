"""kernel.admit_roofline: the grid admit-plane kernel's summed bound over
its summed device time in the window, in percent."""
from reachbench.readers import admit_bound, roofline


def read(run):
    return roofline(run, "repro_torch::bfs_admit_plane", "admit_kernel",
                    admit_bound)
