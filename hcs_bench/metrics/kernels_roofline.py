"""The port's hand-written kernels' share of their roofline in the traced
stretch: the sum over their calls of each call's least time
(``yardstick.bound`` of its bytes and operations) over the sum of the
device time of the ``sag_*`` kernels in the trace."""

from hcs_bench.yardstick import bound


def read(run):
    tr = run.trace
    if tr is None or not run.kernel_work:
        return None
    dev = sum(float(s) for s, n in zip(tr.kernel_seconds(), tr.kernel_names) if "sag_" in n)
    if dev <= 0:
        return None
    least = sum(bound(b, o)[0] for _, b, o in run.kernel_work)
    return 100.0 * least / dev
