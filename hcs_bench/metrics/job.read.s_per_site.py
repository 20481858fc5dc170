"""Seconds of reading a site's TIFFs: the ``read`` stage of each job's own
``StageTimer`` (``run_feature_extraction_job``: every channel decoded and
stacked as float32), summed over the stretch after the profiler stopped,
over the sites completed there."""


def read(run):
    if not run.sites or "job.read" not in run.spans:
        return None
    return run.spans["job.read"] / run.sites
