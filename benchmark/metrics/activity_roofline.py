"""The integrator's share of its byte roofline: the bytes that the live
cells and their proteins need per step (:mod:`benchmark.roofline`), over
the device time of the integrator's own kernels (``integrate`` in the
name: ``integrate_kernel``, ``integrate_grouped_kernel`` of
``csrc/integrate.cu``) launched inside the driver's activity range, in the
traced window.  Other kernels in that range (casts, gathers) are left out;
a range with no such kernel reads nothing."""
from benchmark import roofline

KERNEL = "integrate"


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    kernels = run.trace.range_kernels.get(run.activity_range, {})
    t = sum(s for name, s in kernels.items() if KERNEL in name)
    if t <= 0:
        return None
    n_bytes = run.trace_steps * sum(
        roofline.integrator_bytes(c, p, run.signals) for c, p in run.live)
    return roofline.share_pct(n_bytes, t)
