"""Noise patches generated and downloaded a second: every patch of the
window over all of its time."""


def read(rec):
    return rec["units"] * rec["items_per_unit"] / rec["window_seconds"]
