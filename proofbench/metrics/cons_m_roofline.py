"""The constraint kernel's least time over its device time, in percent, in
a cell of the rv32im AIR, whose every constraint launch is that AIR's
`cons_fused` (3,484 products and 4,461 sums a row, 986 of its 1,038
stacked rows varying, by `roofline.cons_work`).

Counted and read as `cons_roofline` counts and reads: the same counter
on `kernels.cons.launch`, against the profiler's device time of the
`cons_fused` launches in the window."""

from proofbench import harness, roofline

NAME = "cons_m_roofline"
_BASE = harness.metric_module("cons_roofline")
KERNEL = _BASE.KERNEL

LAUNCHES = [("boundless_tpu_torch.kernels.cons", "launch", _BASE._count)]


def read(trace):
    work = trace.launches.get(NAME, [])
    device_s, _ = trace.kernel_seconds([KERNEL])
    if not work or not device_s:
        return None
    least = sum(roofline.least_seconds(i, b) for i, b in work)
    return 100.0 * least / device_s
