"""The share of the experts' capacity slots that held no token while
traced: 100 x (``moe.slots`` - ``moe.slots_filled``) / ``moe.slots``, the
program's counters; an empty slot's products are computed all the same."""

from metrics._spans import counters


def read(run):
    found = counters(run)
    if found is None or not found.get("moe.slots"):
        return None
    return 100.0 * (found["moe.slots"] - found["moe.slots_filled"]) / found["moe.slots"]
