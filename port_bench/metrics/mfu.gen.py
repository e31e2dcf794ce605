"""Share of the bf16 tensor-core peak (989 TFLOP/s) that the window's
evaluations use: their products (harness.flops) over the window's time,
in %."""


def read(rec):
    return 100.0 * rec["units"] * rec["flops_per_unit"] / (
        rec["window_seconds"] * rec["chips"] * rec["peak_flops"])
