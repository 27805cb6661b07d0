"""The NTT launches' least time over their device time, in percent, in a
cell of the rv32im AIR: its data LDE (2^22 x 584 at po2 20) gives
sub-transform launches of more than 2^31 words.

Counted as `ntt_roofline` counts: each launch of `kernels.ntt.sub_ntt`
(`sub_ntt_kernel` of `csrc/ntt.cu`) from its arguments by
`roofline.ntt_work`, against the profiler's device time of the kernel's
launches in the window."""

from proofbench import harness, roofline

NAME = "ntt_m_roofline"
_BASE = harness.metric_module("ntt_roofline")
KERNEL = _BASE.KERNEL

LAUNCHES = [("boundless_tpu_torch.kernels.ntt", "sub_ntt", _BASE._count)]


def read(trace):
    work = trace.launches.get(NAME, [])
    device_s, _ = trace.kernel_seconds([KERNEL])
    if not work or not device_s:
        return None
    least = sum(roofline.least_seconds(i, b) for i, b in work)
    return 100.0 * least / device_s
