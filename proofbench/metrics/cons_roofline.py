"""The constraint kernel's least time over its device time, in percent.

Each launch of the fused constraint kernel (`kernels.cons.launch` ->
`cons_fused` of the library it generates for the AIR) is counted from
its arguments, the AIR's name and the shapes of its grids, weights and
selectors, by `roofline.cons_work`, which counts from the benchmark's
frozen copy of the AIR; its least time is the larger of its bytes and
its instructions at the card's published rates. The device time is the
profiler's, summed over the kernel's launches in the window. A launch
on the CPU, or of an AIR the frozen copy does not hold, is not counted.
"""

from proofbench import roofline

NAME = "cons_roofline"
KERNEL = "cons_fused"

# the frozen AIRs' counts, made before the window opens
for _variant in roofline.CONS_VARIANTS:
    roofline.cons_row_ops(_variant)


def _count(air, ctrl_evals, data_evals, accum_evals, pubvec, weights, sels):
    if data_evals.device.type != "cuda" or \
            air.name not in roofline.CONS_VARIANTS:
        return None
    try:
        return roofline.cons_work(
            air.name, data_evals.shape[0], ctrl_evals.shape[1],
            data_evals.shape[1], accum_evals.shape[1], weights.shape[0],
            len(sels))
    except ValueError:  # a layout other than the frozen AIR's
        return None


LAUNCHES = [("boundless_tpu_torch.kernels.cons", "launch", _count)]


def read(trace):
    work = trace.launches.get(NAME, [])
    device_s, _ = trace.kernel_seconds([KERNEL])
    if not work or not device_s:
        return None
    least = sum(roofline.least_seconds(i, b) for i, b in work)
    return 100.0 * least / device_s
