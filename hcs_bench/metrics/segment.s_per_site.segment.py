"""Seconds of segmentation a site: the benchmark's span around
``segment_batch`` (ending in a sync in the traced run), summed over the
stretch after the profiler stopped, over the sites completed there. The
masks' copy to the host is a span of its own (``labels.host``), not in it."""


def read(run):
    if not run.sites or "segment" not in run.spans:
        return None
    return run.spans["segment"] / run.sites
