"""The NTT launches' least time over their device time, in percent.

Each launch of the sub-transform kernel (`kernels.ntt.sub_ntt` ->
`sub_ntt_kernel` of `csrc/ntt.cu`) is counted from its arguments by
`roofline.ntt_work`; its least time is the larger of its bytes and its
instructions at the card's published rates. The device time is the
profiler's, summed over the kernel's launches in the window."""

from proofbench import roofline

NAME = "ntt_roofline"
KERNEL = "sub_ntt_kernel"


def _count(x, forward, mid=None, *, m=None, inner=None, load=None,
           store=None, rows_out=None):
    if x.device.type != "cuda":
        return None
    rows_in, lanes = x.shape
    m = rows_in if m is None else m
    n2 = 0 if mid is None else mid.shape[1]
    rows_out = m if rows_out is None else rows_out
    if (n2 and m * lanes == 0) or (not n2 and rows_out * lanes == 0):
        return None

    def table(opt):
        if opt is None or opt[0] is None:
            return (0, 0)
        a, b = opt
        return (a.numel(), 0 if b is None else b.numel())

    return roofline.ntt_work(rows_in, lanes, m, n2, table(load),
                             table(store), rows_out)


LAUNCHES = [("boundless_tpu_torch.kernels.ntt", "sub_ntt", _count)]


def read(trace):
    work = trace.launches.get(NAME, [])
    device_s, _ = trace.kernel_seconds([KERNEL])
    if not work or not device_s:
        return None
    least = sum(roofline.least_seconds(i, b) for i, b in work)
    return 100.0 * least / device_s
