"""The published model's FLOPs over the card's dense bf16 peak, in the
stretch after the profiler stopped: CPnet's convolutions on each site
segmented there, over its length. The count is the model's, whatever
implements it."""

from hcs_bench.yardstick import BF16_OPS_PER_S


def read(run):
    if run.span_s <= 0 or not run.sites:
        return None
    flops = run.sites * run.model_flops.get("site", 0.0)
    return 100.0 * flops / (run.span_s * BF16_OPS_PER_S) if flops else None
