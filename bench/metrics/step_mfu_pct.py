"""The whole step's share of one H100's bf16 peak: model FLOPs a step (the
benchmark's own count, ``_roofline.model_flops``) over the window's mean
step time (its wall over its steps)."""

from metrics._roofline import H100_BF16_FLOPS, model_flops


def read(run):
    if not run.steps:
        return None
    step_s = run.window_s / len(run.steps)
    flops = model_flops(run.model, run.traffic["batch"], run.traffic["seq"])
    return 100.0 * flops / step_s / H100_BF16_FLOPS
