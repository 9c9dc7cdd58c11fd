"""The traced part's share in which no device operation ran, in percent:
1 - the union of the device operations' intervals over its span (the
device's activity alone is traced). The profiler's cost a launch
stretches the span of a host-bound DKT step, so the share reads high there
and falls with the host's dispatch."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
