"""Seconds of measurement a site: the benchmark's spans around
``measure_site_batch_dispatch`` and ``measure_site_batch_finalize``
(each ending in a sync in the traced run), summed over the stretch after
the profiler stopped, over the sites completed there."""


def read(run):
    if not run.sites or "measure.dispatch" not in run.spans:
        return None
    return (run.spans["measure.dispatch"] + run.spans.get("measure.finalize", 0.0)) / run.sites
