"""`prove_segment`'s pool of host trace buffers (`zkvm/prove.py`).

A proof takes a buffer for its witness and its upload and hands it back
before the STARK; a buffer is made only when every one of its shape is in
use. On the CPU the buffers are plain numpy, so these tests run the same
reuse the card does (where each buffer is also page-locked: the card's
check is tests/test_torch_upload_cuda.py).
"""

import threading

import numpy as np
import pytest

from boundless_tpu_torch import convert
from boundless_tpu_torch.air.rv32im import DC
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor

PO2 = 8
CPU = "cpu"


@pytest.fixture
def pool(monkeypatch):
    """An empty pool for this test alone."""
    monkeypatch.setattr(prove, "_TRACE_BUFFERS", {})
    return prove._TRACE_BUFFERS


def segment(image, inp, po2=PO2):
    return Executor(image, inp, segment_po2=po2).run().segments[0]


def echo_segment(po2=PO2):
    return segment(guests.echo(), guests.words([3, 11, 22, 33]), po2)


def counts():
    return prove.TRACE_BUFFERS_MADE, prove.TRACE_BUFFER_REUSES


def test_two_threads_proving_at_once_hold_different_buffers(pool,
                                                            monkeypatch):
    seg = echo_segment()
    both_in = threading.Barrier(2, timeout=60)
    held, errors = [], []
    gen = prove._gen_witness

    def gen_held(image, seg, rng=None, out=None):
        held.append(out)
        both_in.wait()  # each thread holds its buffer while the other does
        return gen(image, seg, rng, out)

    monkeypatch.setattr(prove, "_gen_witness", gen_held)

    def run():
        try:
            r = prove.prove_segment(guests.echo(), seg, prove.TEST_PS,
                                    device=CPU)
            assert prove.verify_segment(r, prove.TEST_PS)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    made = prove.TRACE_BUFFERS_MADE
    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(held) == 2 and held[0] is not held[1]
    assert not np.shares_memory(held[0], held[1])
    assert prove.TRACE_BUFFERS_MADE == made + 2
    free = pool[((1 << PO2, DC.total), False)]
    assert len(free) == 2 and {id(b) for b in free} == {id(b) for b in held}


def test_a_second_proof_of_a_shape_reuses_its_buffer(pool):
    seg = echo_segment()
    made, reuses = counts()
    prove.prove_segment(guests.echo(), seg, prove.TEST_PS, device=CPU)
    assert counts() == (made + 1, reuses)
    (buf,) = pool[((1 << PO2, DC.total), False)]
    prove.prove_segment(guests.echo(), seg, prove.TEST_PS, device=CPU)
    assert counts() == (made + 1, reuses + 1)
    assert pool[((1 << PO2, DC.total), False)] == [buf]


def test_shapes_of_different_po2_get_different_buffers(pool):
    cpu = prove._device(CPU)
    shapes = [(1 << po2, DC.total) for po2 in (PO2, PO2 + 1)]
    with prove._trace_buffer(shapes[0], cpu) as (a, reused_a), \
            prove._trace_buffer(shapes[1], cpu) as (b, reused_b):
        assert not (reused_a or reused_b)
        assert (a.shape, b.shape) == tuple(shapes)
        assert a.dtype == b.dtype == np.int64
        assert a.flags.c_contiguous and b.flags.c_contiguous
    assert sorted(pool) == [(s, False) for s in shapes]
    with prove._trace_buffer(shapes[1], cpu) as (again, reused):
        assert reused and again is b


def test_a_proof_through_a_reused_buffer_is_byte_equal_to_a_fresh_one(
        pool, monkeypatch):
    """The pool's buffer, filled with a nonzero pattern and then with
    another guest's witness, gives the proof that a freshly zeroed array
    gives (the same blinding rows from the same rng)."""
    seg = segment(guests.muldiv(), guests.words([0xDEADBEEF, 12345]))
    other = segment(guests.memtest(), guests.words([4, 9, 8, 7, 6]))

    def proof(image, seg):
        r = prove.prove_segment(image, seg, prove.TEST_PS, device=CPU,
                                rng=np.random.default_rng(21))
        return convert.proof_to_numpy(r.proof), r.pub

    with prove._trace_buffer((1 << PO2, DC.total), prove._device(CPU)) \
            as (buf, _):
        buf.fill(0x5A5A5A5A5A5A5A5A)
    proof(guests.memtest(), other)
    reuses = prove.TRACE_BUFFER_REUSES
    reused, reused_pub = proof(guests.muldiv(), seg)
    assert prove.TRACE_BUFFER_REUSES == reuses + 1

    class Fresh:  # the path without a pool: out=None, a zeroed array
        def __enter__(self):
            return None, False

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(prove, "_trace_buffer", lambda shape, dev: Fresh())
    fresh, fresh_pub = proof(guests.muldiv(), seg)
    assert sorted(reused) == sorted(fresh)
    for k in fresh:
        np.testing.assert_array_equal(reused[k], fresh[k], err_msg=k)
    for k in fresh_pub:
        np.testing.assert_array_equal(np.asarray(reused_pub[k]),
                                      np.asarray(fresh_pub[k]), err_msg=k)


def test_many_threads_never_share_a_buffer(pool):
    """More threads than cores take, mark and return buffers of two shapes
    with a short switch interval: a buffer held by one thread is never
    handed to another, every take is counted once, and no more buffers of
    a shape are made than threads."""
    import os
    import sys

    workers, rounds = 2 * (os.cpu_count() or 4), 40
    shapes = [(4, 3), (8, 3)]
    cpu = prove._device(CPU)
    made, reuses = counts()
    errors = []

    def run(me):
        try:
            for i in range(rounds):
                with prove._trace_buffer(shapes[i % 2], cpu) as (buf, _):
                    buf.fill(me)
                    for _ in range(3):
                        if not (buf == me).all():
                            errors.append(f"buffer shared by thread {me}")
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    m, r = counts()
    assert (m - made) + (r - reuses) == workers * rounds
    for shape in shapes:
        assert 1 <= len(pool[(shape, False)]) <= workers
    assert m - made == sum(len(v) for v in pool.values())
