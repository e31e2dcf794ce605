"""Share of the fp32 peak outside the tensor cores (67 TFLOP/s; TF32 is
off) that the window's LSID forwards use: their products over the
window's time, in %."""


def read(rec):
    return 100.0 * rec["units"] * rec["flops_per_unit"] / (
        rec["window_seconds"] * rec["chips"] * rec["peak_flops"])
