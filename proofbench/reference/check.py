"""The judgement that decides `correct`.

The reference works out again, from the program words and the inputs the
benchmark made, everything a receipt claims: it executes the program
(`rv32i.py`: plain RV32I, or RV32IM where the configuration's `variant`
is "rv32im"), builds the program's image table and commits it
(`image.py`, `stark.control_root_of`: the image id), and derives each
segment's public values or the session's span claim. It then holds the
port's receipts to that:

* `claim_fields_wrong`: fields of the receipt that differ from the
  reference's (cycles, journal, exit code, segments; each segment's public
  values and image id; a session's claim fields, its journal, image id,
  root public values and stats). Exact: limit 0.
* `proofs_rejected`: proofs that the plain verifier (`stark.verify`, under
  the configuration's proof system) rejects, or cannot read, against the
  reference's claim and image id; a session's root recursion proof is
  verified against the lattice's control IDs (`control_ids.json`).
  Exact: limit 0.

Nothing here imports the port: the receipts arrive as plain values and
tensors, and the reference reads them only to judge them.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from . import claims as C
from . import field as F
from . import image, paging, rec_air, rv32i, stark
from .rv32im import (CP_IO, IO_MAX, MEM_PAGE_ELEMS, MEM_PAGES, PAGE_WORDS,
                     PublicValues, Rv32imAir, zk_rows)

HERE = os.path.dirname(os.path.abspath(__file__))
LIMITS = {"claim_fields_wrong": 0, "proofs_rejected": 0}
_AIRS = {"rv32im": Rv32imAir(True), "rv32i": Rv32imAir(False)}


def segment_limit(po2: int) -> int:
    """Cycles a segment holds: its rows less the blinded tail and four
    control rows."""
    return (1 << po2) - zk_rows(po2) - 4


def program_words(config: dict) -> Dict[int, int]:
    prog = config["program"]
    return {prog["base"] + 4 * i: int(w) & 0xFFFFFFFF
            for i, w in enumerate(prog["words"])}


def image_id(words: Dict[int, int], po2: int, ps: stark.ProofSystem,
             device) -> List[int]:
    """The program's image id: the root of its committed image table."""
    ctrl = F.fp(image.build_ctrl_trace(words, po2), device)
    root = stark.control_root_of(_AIRS["rv32im"], po2, ctrl, ps)
    return [int(x) for x in F.from_mont(root).cpu()]


def _limbs(regs) -> np.ndarray:
    out = np.zeros(64, dtype=np.int64)
    for k, v in enumerate(regs):
        out[2 * k], out[2 * k + 1] = v & 0xFFFF, v >> 16
    return out


def segment_pub(seg: rv32i.SegmentRun) -> dict:
    """The public values of one segment (the receipt's `pub` layout)."""
    io = np.zeros((IO_MAX, 5), dtype=np.int64)
    for i, (tag, seq, lo, hi) in enumerate(seg.io):
        io[i] = [tag, seq, lo, hi, 1]
    mem = np.zeros((MEM_PAGES, MEM_PAGE_ELEMS), dtype=np.int64)
    pages = sorted({w // PAGE_WORDS for w in seg.pre_mem})
    if len(pages) > MEM_PAGES:
        raise ValueError("a segment touched more pages than it publishes")
    for e, pg in enumerate(pages):
        mem[e, 0], mem[e, 1] = pg, 1
        for w in range(PAGE_WORDS):
            addr = pg * PAGE_WORDS + w
            base = 2 + 5 * w
            touched = addr in seg.pre_mem
            pre = seg.page_words[addr]
            post = seg.post_mem[addr] if touched else pre
            mem[e, base:base + 5] = [int(touched), pre & 0xFFFF, pre >> 16,
                                     post & 0xFFFF, post >> 16]
    return dict(pre_pc=np.int64(seg.pre_pc), post_pc=np.int64(seg.post_pc),
                pre_regs=_limbs(seg.pre_regs), post_regs=_limbs(seg.post_regs),
                halted=np.int64(int(seg.halted)),
                pre_seqs=np.asarray(seg.pre_seqs, dtype=np.int64),
                post_seqs=np.asarray(seg.post_seqs, dtype=np.int64),
                io=io, cpio=np.zeros((CP_IO, 4), dtype=np.int64), mem=mem)


def _pub_tensors(pub: dict, device) -> PublicValues:
    return PublicValues(**{k: F.fp(np.asarray(pub[k], dtype=np.int64),
                                   device) for k in pub})


def _on(proof, device):
    """A proof's tensors (nested tuples of them) on `device`."""
    if isinstance(proof, torch.Tensor):
        return proof.to(device)
    if isinstance(proof, tuple):
        moved = [_on(x, device) for x in proof]
        return type(proof)(*moved) if hasattr(proof, "_fields") \
            else tuple(moved)
    return proof


def _verified(verify) -> bool:
    """A verifier's verdict; a proof it cannot read is rejected."""
    try:
        return bool(verify())
    except (AssertionError, IndexError, RuntimeError, ValueError,
            TypeError, AttributeError) as e:
        print(f"reference: proof not readable: {type(e).__name__}: {e}",
              file=sys.stderr)
        return False


def _journal(words: List[int]) -> bytes:
    return b"".join(int(w).to_bytes(4, "little") for w in words)


def judge_segments(config, got: dict, run: rv32i.Run, image: List[int],
                   device, log) -> tuple:
    """(fields wrong, proofs rejected) of one job of the segment path."""
    ps = stark.ProofSystem(**config["proof_system"])
    po2 = config["segment_po2"]
    wrong = 0
    for name, a, b in (("cycles", got["cycles"], run.cycles),
                       ("journal", got["journal"], _journal(run.journal)),
                       ("exit_code", got["exit_code"], run.exit_code),
                       ("segments", len(got["segments"]), len(run.segments))):
        if a != b:
            wrong += 1
            log(f"{name}: {a!r} against {b!r}")
    rejected = 0
    for seg, want in zip(got["segments"], run.segments):
        pub = segment_pub(want)
        for k, v in pub.items():
            if not np.array_equal(np.asarray(seg["pub"][k]), v):
                wrong += 1
                log(f"segment pub {k} differs")
        if list(seg["image_id"]) != image:
            wrong += 1
            log("image id differs")
        if seg["po2"] != po2 or seg["variant"] != config["variant"]:
            wrong += 1
            log(f"segment po2 {seg['po2']} variant {seg['variant']}")
        root = F.fp(np.asarray(image, dtype=np.int64), device)
        ok = _verified(lambda: stark.verify(
            _AIRS[config["variant"]], _on(seg["proof"], device),
            _pub_tensors(pub, device), po2, root, ps))
        rejected += not ok
    rejected += max(0, len(run.segments) - len(got["segments"]))
    return wrong, rejected


def _control_ids(rec: dict) -> Dict[str, List[int]]:
    """The lattice's control IDs, from the frozen table."""
    with open(os.path.join(HERE, "control_ids.json")) as f:
        table = json.load(f)
    lattice = table[f"rec{rec['rec_po2']}"]
    want = stark.ProofSystem(**rec["proof_system"])
    if stark.ProofSystem(**lattice["proof_system"]) != want:
        raise ValueError("no control IDs for this lattice's proof system")
    return {k: v["control_id"] for k, v in lattice["programs"].items()}


def session_claim(run: rv32i.Run, image: List[int], words, po2: int,
                  entry: int) -> C.Claim:
    """The span claim of a whole session, from the reference's run."""
    z = C.ZERO_CHAIN
    pre_root = paging.PageTree.from_words(
        {a >> 2: v for a, v in words.items()}).root()
    post_root = paging.PageTree.from_words(run.memory).root()
    return C.Claim(
        image_id=tuple(image), pre_pc=entry, post_pc=run.final_pc,
        halted=1, pre_regs=(0,) * 64,
        post_regs=tuple(int(x) for x in _limbs(run.final_regs)),
        pre_seqs=(0, 0, 0, 0),
        post_seqs=(len(run.journal), len(run.inputs_read), 0, 0),
        pre_journal=z, post_journal=C.fold_words(z, run.journal),
        pre_input=z, post_input=C.fold_words(z, run.inputs_read),
        pre_assumptions=z, post_assumptions=z,
        pre_mem_root=tuple(pre_root), post_mem_root=tuple(post_root),
        pre_coproc=z, post_coproc=z, pre_segments=0,
        post_segments=len(run.segments))


def judge_session(config, got: dict, run: rv32i.Run, image: List[int],
                  words, device, log) -> tuple:
    """(fields wrong, proofs rejected) of one session of the cluster."""
    rec = config["recursion"]
    ids = _control_ids(rec)
    want = session_claim(run, image, words, config["segment_po2"],
                         config["program"]["entry"])
    kind = "join" if len(run.segments) > 1 else "lift_i"
    allowed = C.allowed_set_root([ids[k] for k in ("lift_i", "join",
                                                   "resolve")])
    pub = list(want.digest()) + list(allowed) + [0] * 8
    wrong = 0
    for name, a, b in (
            ("journal", got["journal"], _journal(run.journal)),
            ("image_id", got["image_id"], image),
            ("entry_pc", got["entry_pc"], config["program"]["entry"]),
            ("root_kind", got["root_kind"], kind),
            ("root_pub", got["root_pub"], pub),
            ("root_po2", got["root_po2"], rec["rec_po2"]),
            ("stats.total_cycles", got["stats"].get("total_cycles"),
             run.cycles),
            ("stats.segments", got["stats"].get("segments"),
             len(run.segments)),
            ("stats.exit_code", got["stats"].get("exit_code"),
             run.exit_code)):
        if a != b:
            wrong += 1
            log(f"{name}: {a!r} against {b!r}")
    for name, value in got["root_claim"].items():
        ref = getattr(want, name)
        as_tuple = tuple(int(x) for x in value) \
            if isinstance(value, (tuple, list)) else int(value)
        if as_tuple != ref:
            wrong += 1
            log(f"claim {name} differs")
    rps = stark.ProofSystem(**rec["proof_system"])
    root = F.fp(np.asarray(ids[kind], dtype=np.int64), device)
    ok = _verified(lambda: stark.verify(
        rec_air.AIR, _on(got["root_proof"], device),
        rec_air.pub_array(pub, device), rec["rec_po2"], root, rps))
    return wrong, int(not ok)


def judge(config: dict, outputs: list, device) -> dict:
    """The compared numbers over the judged jobs, each with its limit."""
    words = program_words(config)
    po2 = config["segment_po2"]
    ps = stark.ProofSystem(**config["proof_system"])
    image_words = image_id(words, po2, ps, device)
    entry = config["program"]["entry"]
    totals = dict(claim_fields_wrong=0, proofs_rejected=0)
    for index, got in outputs:
        def log(msg, index=index):
            print(f"reference: job {index}: {msg}", file=sys.stderr)

        run = rv32i.execute(words, entry, got["inputs"], segment_limit(po2),
                            m_ext=config["variant"] == "rv32im")
        if got["kind"] == "segments":
            w, r = judge_segments(config, got, run, image_words, device, log)
        else:
            w, r = judge_session(config, got, run, image_words, words,
                                 device, log)
        totals["claim_fields_wrong"] += w
        totals["proofs_rejected"] += r
    return {k: dict(value=v, limit=LIMITS[k], rule="at most")
            for k, v in totals.items()}


def passes(checks: dict) -> bool:
    for c in checks.values():
        if c.get("rule", "at most") == "at most" and c["value"] > c["limit"]:
            return False
        if c.get("rule") == "at least" and c["value"] < c["limit"]:
            return False
    return True
