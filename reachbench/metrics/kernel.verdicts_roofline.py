"""kernel.verdicts_roofline: the grid verdict kernel's summed bound over
its summed device time in the window, in percent."""
from reachbench.readers import roofline, verdicts_bound


def read(run):
    return roofline(run, "repro_torch::dbl_query_verdicts",
                    "verdicts_kernel", verdicts_bound(run))
