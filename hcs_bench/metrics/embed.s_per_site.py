"""Seconds of embedding a site: the benchmark's span around
``embed_sites_pooled`` inside ``process_site_batch`` (ending in a sync in
the traced run), summed over the stretch after the profiler stopped, over the sites
completed there."""


def read(run):
    if not run.sites or "embed" not in run.spans:
        return None
    return run.spans["embed"] / run.sites
