"""query.device_ms: device-busy ms inside the query calls, per call."""
from reachbench.readers import range_device_ms


def read(run):
    return range_device_ms(run, "query")
