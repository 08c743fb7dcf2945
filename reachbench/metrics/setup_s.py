"""setup_s: seconds from the harness's start to the window's: making the
graph, building the index, the engine's warmup and the mix's warm
steps."""


def read(run):
    return run.setup_s
