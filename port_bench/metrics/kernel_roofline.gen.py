"""The port's hand-written kernels in the traced batches against their
roofline: the sum of each call's bound (harness.roofline, from the call
shapes of an evaluation) over the device time of every kernel the port's
CUDA sources declare, in %."""


def read(rec):
    t = rec.get("trace")
    if not t or t["handwritten_s"] <= 0:
        return None
    return 100.0 * t["units"] * t["bound_s_per_unit"] / t["handwritten_s"]
