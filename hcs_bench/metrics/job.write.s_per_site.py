"""Seconds of writing a site's CSVs: the ``write`` stage of each job's own
``StageTimer`` (``run_feature_extraction_job``: the four tables
concatenated and written as CSV), summed over the stretch after the
profiler stopped, over the sites completed there."""


def read(run):
    if not run.sites or "job.write" not in run.spans:
        return None
    return run.spans["job.write"] / run.sites
