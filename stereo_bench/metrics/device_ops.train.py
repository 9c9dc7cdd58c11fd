"""Device operations (kernels, copies, fills) a DKT step in the traced
part."""


def read(rec):
    t = rec.get("trace")
    return t["device_ops"] / t["units"] if t and t["device_ops"] else None
