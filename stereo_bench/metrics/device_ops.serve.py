"""Device operations (kernels, copies, fills) a frame in the traced part."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["device_ops"]:
        return None
    return t["device_ops"] / (t["units"] * rec["frames_per_unit"])
