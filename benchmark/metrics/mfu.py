"""The whole call: its operations (counted as for ``roofline_share``) over
the traced call time times the chips' bf16 dense peak, in %."""

from benchmark.harness import roofline


def read(run):
    if not run.traced_window_s or not run.calls or run.busy_s is None:
        return None
    flops = run.work["tc_flops"] + run.work["f32_flops"]
    per_call = run.traced_window_s / run.calls
    return 100.0 * flops / (per_call * roofline.BF16_TC_FLOPS * run.world)
