"""The Poseidon2 sponge's least time over its device time, in percent.

Each launch of the sponge (`kernels.poseidon2._sponge` -> `sponge_kernel`
of `csrc/poseidon2.cu`: leaf hashes, tree levels, transcript permutes)
and of the one-block tree top (`kernels.poseidon2.hash_tree` ->
`tree_kernel`) is counted from its arguments by `roofline.sponge_work`
and `roofline.tree_work`; its least time is the larger of its bytes and
its instructions at the card's published rates. The device time is the
profiler's, summed over both kernels' launches in the window."""

from proofbench import roofline

NAME = "sponge_roofline"
KERNELS = ("sponge_kernel", "tree_kernel")


def _sponge(matrix, init, out_words, lanes=None):
    if matrix.device.type != "cuda" or matrix.shape[0] == 0:
        return None
    n, c = matrix.shape
    return roofline.sponge_work(n, c, init is not None, out_words)


def _tree(level):
    if level.device.type != "cuda":
        return None
    return roofline.tree_work(level.shape[0])


LAUNCHES = [("boundless_tpu_torch.kernels.poseidon2", "_sponge", _sponge),
            ("boundless_tpu_torch.kernels.poseidon2", "hash_tree", _tree)]


def read(trace):
    work = trace.launches.get(NAME, [])
    device_s, _ = trace.kernel_seconds(KERNELS)
    if not work or not device_s:
        return None
    least = sum(roofline.least_seconds(i, b) for i, b in work)
    return 100.0 * least / device_s
