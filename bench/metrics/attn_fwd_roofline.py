"""Attention's forward kernels against their roofline: the least time of
every forward call the trace shows (``_roofline.attention_bound_s`` of the
model's attention shape) over those kernels' device time.  A trace with no
such kernel gives nothing."""

from metrics._kernels import FORWARD, attention_call, matches
from metrics._roofline import attention_bound_s


def read(run):
    if run.trace is None:
        return None
    times = [t for name, t in run.trace.kernels if matches(name, FORWARD)
             and "combine" not in name]
    if not times:
        return None
    spent = sum(t for name, t in run.trace.kernels if matches(name, FORWARD))
    return 100.0 * len(times) * attention_bound_s(*attention_call(run)) / spent
