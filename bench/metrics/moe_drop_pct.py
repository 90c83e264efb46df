"""The share of the MoE's (token, expert) assignments dropped past an
expert's capacity while traced: 100 x ``moe.dropped`` / ``moe.assignments``,
the program's counters of its routing (summed on the device)."""

from metrics._spans import counters


def read(run):
    found = counters(run)
    if found is None or not found.get("moe.assignments"):
        return None
    return 100.0 * found["moe.dropped"] / found["moe.assignments"]
