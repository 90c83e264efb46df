"""Attention's backward kernels against their roofline: the least time of
every backward call the trace shows (one ``attn_bwd_prep_kernel`` a call;
``_roofline.attention_bwd_bound_s`` of the model's attention shape) over the
device time of all the backward's kernels.  A trace with none gives
nothing."""

from metrics._kernels import BACKWARD, BACKWARD_CALL, attention_call, matches
from metrics._roofline import attention_bwd_bound_s


def read(run):
    if run.trace is None:
        return None
    calls = sum(1 for name, _ in run.trace.kernels if BACKWARD_CALL in name)
    spent = sum(t for name, t in run.trace.kernels if matches(name, BACKWARD))
    if not calls or spent <= 0:
        return None
    return 100.0 * calls * attention_bwd_bound_s(*attention_call(run)) / spent
