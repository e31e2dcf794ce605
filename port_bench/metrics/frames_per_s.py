"""Full SID frames evaluated a second: every frame of the window over all
of its time."""


def read(rec):
    return rec["units"] * rec["items_per_unit"] / rec["window_seconds"]
