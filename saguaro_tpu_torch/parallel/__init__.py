"""Multi-process job partitioning (``parallel.distributed``)."""
