"""The published models' FLOPs over the card's dense bf16 peak, in the
stretch after the profiler stopped: CPnet's convolutions on each site
segmented there and EfficientNetV2's forward on each crop embedded there,
over its length. The count is the models', whatever implements them."""

from hcs_bench.yardstick import BF16_OPS_PER_S


def read(run):
    if run.span_s <= 0 or not run.sites:
        return None
    flops = run.sites * run.model_flops.get("site", 0.0) + run.span_crops * run.model_flops.get("crop", 0.0)
    return 100.0 * flops / (run.span_s * BF16_OPS_PER_S) if flops else None
