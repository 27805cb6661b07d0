"""Segment proving pipeline: executor segment -> SegmentReceipt, on torch.

Counterpart of `boundless_tpu/zkvm/prove.py`: the witness (C++ cycle loop
when g++ is available, else the Python replay), the program's image table
as the ctrl trace (its Merkle root is the image id), and the port's STARK
prover on the RV32IM AIR variant the program needs. Proofs run on the CUDA
card by default, where every hash, NTT and constraint evaluation goes
through the hand-written kernels; with no card the entry points raise. A
CPU run passes `device="cpu"` (the plain torch versions of the kernels).

`NATIVE_WITNESSES` / `REPLAY_WITNESSES` count the witnesses that came from
the C++ generator and from the Python replay.

The witness's host trace buffer. `prove_segment` fills a (2^po2, 584)
int64 buffer taken from a pool and hands it back once the upload has
read it, before the STARK: a buffer is made only when every one of its
shape is in use, so the pool holds as many of a shape as proofs of that
shape ran at once (one in a single prover, one a prove thread in the
cluster), kept for the life of the process. On a CUDA device a buffer is
page-locked once when it is made (`cudaHostRegister`), so the upload's
copies run from it as DMA, and no segment faults in a fresh 4.9 GB array
at po2 20. `TRACE_BUFFERS_MADE` / `TRACE_BUFFER_REUSES` count the
buffers made and the proofs that took one already made; the span
`zkvm.witness` says which (`buffer="new"` / `"reused"`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from ..air.rv32im import DC, Rv32imAir
from ..core import field as F
from ..prover import stark
from ..utils import profiling
from . import witness
from .executor import GuestFault, MemoryImage, Segment

# 100 queries at commit rate 1/2: the reference's default proof system.
DEFAULT_PS = stark.ProofSystem(queries=100, fri_min_degree=256)
# Small system for CI (NOT production soundness).
TEST_PS = stark.ProofSystem(queries=8, fri_min_degree=16)

_AIRS = {"rv32im": Rv32imAir(), "rv32i": Rv32imAir(False)}

NATIVE_WITNESSES = 0
REPLAY_WITNESSES = 0
TRACE_BUFFERS_MADE = 0
TRACE_BUFFER_REUSES = 0
# the cluster's worker threads share the counters, the image cache and
# the trace buffers
_LOCK = threading.Lock()
# (shape, page-locked) -> the trace buffers of that kind not in use
_TRACE_BUFFERS: dict = {}


def _device(device) -> torch.device:
    """The proof's device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port proves on the card by "
                           "default; pass device=\"cpu\" to prove on the CPU")
    return dev


def image_uses_m(image) -> bool:
    """True iff any decoded instruction word of the image is an M op."""
    return any(witness.decode_row(a, w)[-1] for a, w in image.words.items())


def air_variant_of(image, seg: Optional[Segment] = None) -> str:
    """AIR variant for a program (and segment): keccak bursts and M ops
    need "rv32im"; everything else proves under the thinner "rv32i"."""
    if seg is not None and getattr(seg, "kec_perms", 0):
        return "rv32im"
    return "rv32im" if image_uses_m(image) else "rv32i"


@dataclasses.dataclass
class SegmentReceipt:
    """Proof + claim for one segment (claim values canonical numpy)."""

    proof: stark.SegmentProof
    pub: dict  # canonical claim values (witness.SegmentWitness.pub)
    image_id: np.ndarray  # (8,) canonical u32 digest words
    po2: int
    variant: str = "rv32im"


_IMAGE_CTRL_CACHE: dict = {}


def _image_ctrl(image: MemoryImage, po2: int, ps: stark.ProofSystem,
                device="cuda"):
    """(ctrl trace tensor, canonical image id) for a program, cached."""
    device = _device(device)
    key = (image.image_id(), po2, ps.commit_expand, str(device))
    with _LOCK:
        if key not in _IMAGE_CTRL_CACHE:
            ctrl = F.fp(witness.build_ctrl_trace(image, po2), device)
            root = stark.control_root_of(_AIRS["rv32im"], po2, ctrl, ps)
            # uint32, as the JAX package's image id (the wire format's type)
            _IMAGE_CTRL_CACHE[key] = (
                ctrl, F.from_mont(root).cpu().numpy().view(np.uint32))
        return _IMAGE_CTRL_CACHE[key]


def image_id_of(image: MemoryImage, po2: int,
                ps: stark.ProofSystem = DEFAULT_PS,
                device="cuda") -> np.ndarray:
    """Proof-level image id: Merkle root of the image-table commitment."""
    return _image_ctrl(image, po2, ps, device)[1]


def mem_root(words: dict) -> tuple:
    """Sparse page-tree root (zkvm/paging.py) of a byte-addressed word
    store: the claims' pre/post memory roots, chained across segments."""
    from . import paging

    return paging.PageTree.from_words(
        {a >> 2: v for a, v in words.items()}).root()


def _make_trace_buffer(shape, pinned: bool) -> np.ndarray:
    """A C-contiguous int64 host array of `shape`; `pinned`: page-locked
    for the card's copies (unregistered when the array is freed). A
    failed registration leaves it pageable, which the upload reads too."""
    buf = np.empty(shape, dtype=np.int64)
    if pinned:
        cudart = torch.cuda.cudart()
        ptr = buf.ctypes.data
        # cudaHostRegisterPortable: page-locked for every device's context
        if int(cudart.cudaHostRegister(ptr, buf.nbytes, 1)) == 0:
            weakref.finalize(buf, cudart.cudaHostUnregister, ptr)
    return buf


@contextlib.contextmanager
def _trace_buffer(shape, device: torch.device):
    """(buffer, reused) for one proof's witness: a free buffer of `shape`
    from the pool, else a new one (page-locked on a CUDA device); back to
    the pool on exit."""
    global TRACE_BUFFERS_MADE, TRACE_BUFFER_REUSES
    key = (tuple(shape), device.type == "cuda")
    with _LOCK:
        free = _TRACE_BUFFERS.setdefault(key, [])
        buf = free.pop() if free else None
        if buf is not None:
            TRACE_BUFFER_REUSES += 1
    reused = buf is not None
    if not reused:
        buf = _make_trace_buffer(*key)
        with _LOCK:
            TRACE_BUFFERS_MADE += 1
    try:
        yield buf, reused
    finally:
        with _LOCK:
            free.append(buf)


def _gen_witness(image, seg, rng=None, out=None):
    """The C++ witness generator (into `out` when given, see
    `witness.trace_segment_native`); the Python replay, into an array of
    its own, only when the native library cannot be built or loaded
    (guest faults propagate)."""
    global NATIVE_WITNESSES, REPLAY_WITNESSES
    try:
        w = witness.trace_segment_native(image, seg, seg.po2, rng, out)
    except GuestFault:
        raise
    except (OSError, AttributeError, subprocess.SubprocessError):
        with _LOCK:
            REPLAY_WITNESSES += 1
        return witness.trace_segment(image, seg, seg.po2, rng)
    with _LOCK:
        NATIVE_WITNESSES += 1
    return w


def prove_segment(image: MemoryImage, seg: Segment,
                  ps: stark.ProofSystem = DEFAULT_PS, device="cuda",
                  rng: Optional[np.random.Generator] = None
                  ) -> SegmentReceipt:
    """Generate the witness and prove one segment on `device` (the card
    unless the caller asks for the CPU)."""
    device = _device(device)
    variant = air_variant_of(image, seg)
    air = _AIRS[variant]
    with profiling.span("prove_segment", po2=seg.po2, variant=variant,
                        cols=air.data_cols):
        # the upload has read the buffer when it returns (its copies are
        # synchronised), so the buffer goes back before the STARK
        with _trace_buffer((1 << seg.po2, DC.total),
                           device) as (buf, reused):
            with profiling.span("zkvm.witness",
                                buffer="reused" if reused else "new"):
                w = _gen_witness(image, seg, rng, buf)
            data = F.upload(witness.data_for_variant(w.data, variant),
                            device)
        ctrl, image_id = _image_ctrl(image, seg.po2, ps, device)
        pub = witness.to_public_values(w.pub, device)
        proof = stark.prove(air, data, pub, seg.po2, ps, ctrl)
    return SegmentReceipt(proof=proof, pub=w.pub, image_id=image_id,
                          po2=seg.po2, variant=variant)


def dev_receipt(image: MemoryImage, seg: Segment,
                ps: stark.ProofSystem = DEFAULT_PS,
                device="cuda") -> SegmentReceipt:
    """Dev-mode receipt: the real witness publics and image id (computed
    on `device`), no proof. Instant and NOT sound: a development fixture."""
    w = _gen_witness(image, seg)
    _, image_id = _image_ctrl(image, seg.po2, ps, device)
    return SegmentReceipt(proof=None, pub=w.pub, image_id=image_id,
                          po2=seg.po2, variant=air_variant_of(image, seg))


def verify_segment(receipt: SegmentReceipt,
                   ps: stark.ProofSystem = DEFAULT_PS) -> bool:
    """Verify a SegmentReceipt against its claimed image id, on the
    device its proof lives on."""
    device = receipt.proof.data_root.device
    pub = witness.to_public_values(receipt.pub, device)
    control_root = F.fp(np.asarray(receipt.image_id, dtype=np.int64), device)
    ok = stark.verify(_AIRS[receipt.variant], receipt.proof, pub,
                      receipt.po2, control_root, ps)
    return bool(ok)
