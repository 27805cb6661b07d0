"""Workflow agent: worker poll loop + task handlers.

Re-design of the reference agent (`prover/crates/workflow/src/lib.rs`:
`Agent` :186-206, `poll_work` :525-683, `process_work` :686-797): one
worker object whose mode is its task stream (exec / prove / join / coproc /
snark / aux), polling taskdb, dispatching TaskType, with retry bookkeeping
and hot-store cleanup-after-done semantics. Workers here are threads in
one process (the cluster fabric is in-process dict/sqlite); the REST API
layer (api.py) exposes the same surface across processes.

Task flow for a session (reference §3.1 call stack):
  exec: run the rv32im executor, stream segments into the hot store,
        drive the MMR planner to create prove/join/finalize tasks
  prove: witness + segment STARK (the card's hot path) + lift
  join: pairwise claim join along the tree
  resolve: discharge assumptions from the receipts store
  finalize: SessionReceipt -> object store receipts/stark/<job>.

The port's copy of `boundless_tpu/cluster/agent.py`. Every proof runs on
`ClusterContext.device` (the card unless the caller asks for the CPU):
segment proofs, lifts, joins, resolves, keccak batches and the wrap. The
worker threads of `run_workers` share the card; each launches on the
default stream, and the kernels' launch counters and the prover's caches
take a lock. Keccak batches are proved and verified at the succinct
coproc lattice's `kec_ps` when a real lattice is configured (its
lift_keccak program verifies batches at that system), else at `ps`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Optional

from . import hotstore as hs
from .planner import Planner, Kind
from .storage import SharedFs
from .taskdb import MemoryBackend
from ..prover import stark
from ..recursion import claims, succinct
from ..recursion import receipt as rec
from ..zkvm import prove as zprove
from ..zkvm.executor import Executor, MemoryImage

STREAMS = ("exec", "prove", "join", "coproc", "snark", "aux")
_SYSTEM_LOCK = threading.Lock()  # the lazy "real" recursion system


@dataclasses.dataclass
class ClusterContext:
    """Shared fabric handles (taskdb + hot store + object store).

    `succinct`: optional recursion system (succinct.SuccinctSystem or
    succinct.DevModeSystem). When set, the recursion tasks produce
    constant-size RecReceipts (claim v2 chains) instead of the v1
    aggregation receipts. `dev_mode` (reference `RISC0_DEV_MODE=true`)
    skips segment STARKs — valid only with a DevModeSystem.
    """

    db: MemoryBackend
    hot: hs.HotStore
    store: SharedFs
    ps: stark.ProofSystem = zprove.DEFAULT_PS
    segment_po2: int = 14
    exec_cycle_limit: int = 100_000 * (1 << 20)  # reference default
    # "real" (default): the succinct recursion system, built lazily on
    # first use from (segment_po2, ps) — serving produces constant-size
    # RecReceipts out of the box (reference clusters always lift+join,
    # prove.rs:68-95). Pass succinct=None explicitly for the legacy v1
    # aggregation layer, or a DevModeSystem for fake receipts.
    succinct: Optional[object] = "real"
    dev_mode: bool = False
    coproc_po2: int = 8  # keccak batch segment size (10 perms at 2^8)
    # optional succinct coproc lattice (recursion.coproc_succinct
    # .CoprocSystem / DevModeCoprocSystem): when set, keccak batches are
    # lifted to constant-size coproc receipts and the union tree runs
    # the succinct union program alongside the aggregation plane
    # (reference union.rs:44-50 SuccinctReceipt semantics).
    coproc_succinct: Optional[object] = None
    # where every proof of the cluster runs; a CUDA device without a card
    # raises here (zkvm/prove._device)
    device: str = "cuda"

    def __post_init__(self):
        if self.dev_mode and not hasattr(self.succinct, "DEV_ROOT"):
            raise ValueError("dev_mode requires succinct=DevModeSystem")
        zprove._device(self.device)

    def succinct_sys(self):
        """The recursion system, resolving the lazy "real" default
        (program construction + control-id derivation happen once).
        When a succinct coproc lattice is configured, its params link
        into the main system so resolve_coproc joins the allowed set.
        Worker threads resolve it under a lock, so it is built once."""
        with _SYSTEM_LOCK:
            if self.succinct == "real":
                from ..recursion import succinct as S

                rec_po2 = 20 if self.ps.queries >= 50 else 17
                cp = getattr(self.coproc_succinct, "params", None)
                self.succinct = S.get_system(S.SuccinctParams(
                    seg_po2=self.segment_po2, seg_ps=self.ps,
                    rec_po2=rec_po2, rec_ps=self.ps), cp, self.device)
            return self.succinct

    def kec_ps(self) -> stark.ProofSystem:
        """Proof system of the keccak batches: the succinct coproc
        lattice's `kec_ps` when one is configured, else `ps`."""
        params = getattr(self.coproc_succinct, "params", None)
        return self.ps if params is None else params.kec_ps


class Agent:
    """One worker; `stream` selects its task type (reference Args)."""

    def __init__(self, ctx: ClusterContext, stream: str, worker_id: str = ""):
        assert stream in STREAMS
        self.ctx = ctx
        self.stream = stream
        self.worker_id = worker_id or f"{stream}-{id(self) & 0xFFFF:x}"
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def poll_work(self, idle_timeout: Optional[float] = None):
        """Poll until stopped (or idle for idle_timeout seconds).

        Aux workers additionally run the maintenance crons (reference
        lib.rs:531-605: requeue expired leases, fix stuck-pending tasks,
        purge expired hot-store keys).
        """
        idle_since = time.time()
        last_maint = 0.0
        while not self._stop.is_set():
            if self.stream == "aux" and time.time() - last_maint > 1.0:
                last_maint = time.time()
                from . import metrics as M

                n = self.ctx.db.requeue_expired()
                if n:
                    M.REGISTRY.counter("tasks_requeued_total").inc(n)
                stuck = self.ctx.db.fix_stuck_pending()
                if stuck:
                    M.REGISTRY.counter("tasks_stuck_fixed_total").inc(stuck)
                self.ctx.hot.purge_expired()
            task = self.ctx.db.request_work(self.stream, self.worker_id,
                                            timeout=0.2)
            if task is None:
                if idle_timeout and time.time() - idle_since > idle_timeout:
                    return
                continue
            idle_since = time.time()
            from . import metrics as M

            try:
                with M.REGISTRY.histogram(M.TASK_DURATION,
                                          stream=self.stream).time():
                    output, cleanup = self.process_work(task)
                self.ctx.db.update_task_done(task.job_id, task.task_id,
                                             output or {})
                self.ctx.hot.delete(*cleanup)
                M.REGISTRY.counter(M.TASKS_PROCESSED,
                                   stream=self.stream).inc()
            except Exception as e:  # noqa: BLE001 — retry semantics
                err = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                M.REGISTRY.counter(M.TASKS_RETRIED, stream=self.stream).inc()
                self.ctx.db.update_task_retry(task.job_id, task.task_id, err)

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------------------
    def process_work(self, task):
        kind = task.definition["kind"]
        handler = getattr(self, f"_task_{kind}")
        return handler(task)

    # --- exec ----------------------------------------------------------
    def _task_exec(self, task):
        d = task.definition
        image: MemoryImage = self.ctx.store.get("elfs", d["image_id"])
        if image is None:
            raise RuntimeError(f"unknown image {d['image_id']}")
        input_bytes = self.ctx.store.get_bytes("inputs", d["input_id"]) or b""
        po2 = d.get("segment_po2", self.ctx.segment_po2)
        execute_only = d.get("execute_only", False)
        ex = Executor(image, input_bytes, segment_po2=po2,
                      max_cycles=d.get("exec_cycle_limit",
                                       self.ctx.exec_cycle_limit))
        result = ex.run()
        job = task.job_id
        self.ctx.hot.set(hs.exec_stats_key(job), dict(
            total_cycles=result.total_cycles,
            segments=len(result.segments),
            exit_code=result.exit_code,
            journal=result.journal,
            image_id=result.image_id.hex()))
        self.ctx.store.put_bytes("exec_logs", job, result.log)
        self.ctx.store.put_bytes("preflight_journals", job, result.journal)
        if execute_only:
            return dict(total_cycles=result.total_cycles,
                        segments=len(result.segments)), []

        # Stream segments + drive the planner incrementally
        # (reference executor.rs:571-711).
        planner = Planner()
        tid_of = {}
        chain_meta = None
        if self.ctx.succinct_sys() is not None:
            # Per-segment pre-chains: prefix folds of the session word
            # streams at each segment's pre_seqs (recursion/claims.py).
            chain_meta = _segment_pre_chains(ex, result)
            d = dict(d, assumptions=[a.hex() for a in result.assumptions])
        for seg in result.segments:
            self.ctx.hot.set(hs.segment_key(job, seg.index), seg)
            planner.enqueue_segment(seg.index)
            self._emit_ready(job, planner, tid_of, d, chain_meta)
        # coprocessor stream: batch the session's keccak permutations and
        # drive the union tree (reference executor.rs:614-676)
        if ex.keccak_states:
            from ..air.keccak import max_perms
            from ..recursion import claims as rclaims
            from ..recursion import coproc_succinct as rcs

            batch = max(1, max_perms(self.ctx.coproc_po2))
            states = ex.keccak_states
            d = dict(d, keccak_claims=[c.hex() for c in ex.keccak_claims])
            # per-batch digest-chain prefixes (the succinct lattice's
            # span semantics: batch i lifts with pre = fold(batches <i))
            chain, count = rclaims.ZERO_CHAIN, 0
            for b in range(0, len(states), batch):
                idx = b // batch
                self.ctx.hot.set(hs.coproc_state_key(job, idx),
                                 dict(states=states[b : b + batch],
                                      pre_chain=list(chain),
                                      pre_count=count))
                for cdig in ex.keccak_claims[b : b + batch]:
                    chain = rcs.chain_step(
                        chain, rclaims.digest_from_bytes(cdig))
                    count += 1
                planner.enqueue_keccak(idx)
                self._emit_ready(job, planner, tid_of, d, chain_meta)
        fin = planner.finish()
        self._emit_ready(job, planner, tid_of, d, chain_meta)
        return dict(total_cycles=result.total_cycles,
                    segments=len(result.segments),
                    root_task=f"t{planner.root}"), []

    def _emit_ready(self, job, planner: Planner, tid_of, d,
                    chain_meta=None):
        while (cmd := planner.next_task()) is not None:
            name = f"t{cmd.task_id}"
            tid_of[cmd.task_id] = name
            deps = [tid_of[x] for x in cmd.deps]
            if cmd.kind == Kind.SEGMENT:
                pdef = dict(kind="prove", segment=cmd.payload,
                            out=name, **_fwd(d))
                if chain_meta is not None:
                    pdef["pre_chains"] = chain_meta[cmd.payload]
                self.ctx.db.create_task(job, name, "prove", pdef, deps)
            elif cmd.kind == Kind.JOIN:
                self.ctx.db.create_task(job, name, "join",
                                        dict(kind="join", deps=deps,
                                             out=name), deps)
            elif cmd.kind == Kind.KECCAK:
                self.ctx.db.create_task(job, name, "coproc",
                                        dict(kind="keccak",
                                             claim=cmd.payload, out=name),
                                        deps)
            elif cmd.kind == Kind.UNION:
                self.ctx.db.create_task(job, name, "join",
                                        dict(kind="union", deps=deps,
                                             out=name), deps)
            elif cmd.kind == Kind.FINALIZE:
                # resolve (if assumptions/coproc) then finalize
                rdef = dict(kind="resolve", root=tid_of[cmd.deps[0]],
                            assumptions=d.get("assumptions", []),
                            keccak_claims=d.get("keccak_claims", []),
                            **_fwd(d))
                if len(cmd.deps) > 1:
                    rdef["coproc_root"] = tid_of[cmd.deps[1]]
                self.ctx.db.create_task(job, "resolve", "join", rdef, deps)
                self.ctx.db.create_task(job, "finalize", "aux",
                                        dict(kind="finalize", **_fwd(d)),
                                        ["resolve"])

    # --- prove ---------------------------------------------------------
    def _task_prove(self, task):
        d = task.definition
        job = task.job_id
        seg = self.ctx.hot.get(hs.segment_key(job, d["segment"]))
        if seg is None:
            raise RuntimeError(f"segment {d['segment']} missing from hot store")
        image = self.ctx.store.get("elfs", d["image_id"])
        if self.ctx.dev_mode:
            sr = zprove.dev_receipt(image, seg, ps=self.ctx.ps,
                                    device=self.ctx.device)
        else:
            sr = zprove.prove_segment(image, seg, ps=self.ctx.ps,
                                      device=self.ctx.device)
        # RAM continuity: the claim's memory roots are PageTree roots of
        # the segment's entry memory and its public page updates; in the
        # succinct path the lift program derives the post root IN-CIRCUIT
        # (recursion/succinct.py; reference prove.rs:68-95 lift claims)
        if self.ctx.succinct_sys() is not None:
            pre_chains = _decode_chains(d["pre_chains"])
            lifted = self.ctx.succinct_sys().lift(
                sr, pre_chains, pre_mem=seg.pre_mem,
                seg_index=int(d["segment"]))
            claim_hex = claims.digest_bytes(lifted.claim.digest()).hex()
        else:
            lifted = rec.lift(sr, ps=self.ctx.ps, pre_mem=seg.pre_mem)
            claim_hex = lifted.claim_digest().hex()
        self.ctx.hot.set(hs.recursion_receipt_key(job, d["out"]), lifted)
        return dict(claim=claim_hex), [hs.segment_key(job, d["segment"])]

    # --- join / union / resolve ---------------------------------------
    def _task_join(self, task):
        d = task.definition
        job = task.job_id
        left = self.ctx.hot.get(hs.recursion_receipt_key(job, d["deps"][0]))
        right = self.ctx.hot.get(hs.recursion_receipt_key(job, d["deps"][1]))
        if left is None or right is None:
            raise RuntimeError("join inputs missing from hot store")
        if self.ctx.succinct_sys() is not None:
            joined = self.ctx.succinct_sys().join(left, right)
            claim_hex = claims.digest_bytes(joined.claim.digest()).hex()
        else:
            joined = rec.join(left, right)
            claim_hex = joined.claim_digest().hex()
        self.ctx.hot.set(hs.recursion_receipt_key(job, d["out"]), joined)
        return dict(claim=claim_hex), [
            hs.recursion_receipt_key(job, d["deps"][0]),
            hs.recursion_receipt_key(job, d["deps"][1])]

    def _task_union(self, task):
        """Pairwise union of coprocessor receipts (reference
        union.rs:44; aggregation semantics — the succinct union program
        is staged, docs/PROTOCOL.md)."""
        from ..zkvm import coproc

        d = task.definition
        job = task.job_id
        left = self.ctx.hot.get(hs.keccak_receipt_key(job, d["deps"][0]))
        right = self.ctx.hot.get(hs.keccak_receipt_key(job, d["deps"][1]))
        if left is None or right is None:
            raise RuntimeError("union inputs missing from hot store")
        u = coproc.union(left, right)
        self.ctx.hot.set(hs.keccak_receipt_key(job, d["out"]), u)
        cleanup = [hs.keccak_receipt_key(job, d["deps"][0]),
                   hs.keccak_receipt_key(job, d["deps"][1])]
        if self.ctx.coproc_succinct is not None:
            ls = self.ctx.hot.get(hs.coproc_succ_key(job, d["deps"][0]))
            rs = self.ctx.hot.get(hs.coproc_succ_key(job, d["deps"][1]))
            if ls is not None and rs is not None:
                us = self.ctx.coproc_succinct.union(ls, rs)
                self.ctx.hot.set(hs.coproc_succ_key(job, d["out"]), us)
                cleanup += [hs.coproc_succ_key(job, d["deps"][0]),
                            hs.coproc_succ_key(job, d["deps"][1])]
        return dict(digests=len(u.digests())), cleanup

    def _task_keccak(self, task):
        """Prove one keccak batch (reference keccak.rs:71-84)."""
        from ..zkvm import coproc

        d = task.definition
        job = task.job_id
        payload = self.ctx.hot.get(hs.coproc_state_key(job, d["claim"]))
        if payload is None:
            raise RuntimeError("keccak states missing from hot store")
        if isinstance(payload, dict):
            states = payload["states"]
            pre_chain = tuple(payload["pre_chain"])
            pre_count = int(payload["pre_count"])
        else:  # pre-r4 wire format: bare state list
            states, pre_chain, pre_count = payload, None, 0
        r = coproc.prove_keccak(states, po2=self.ctx.coproc_po2,
                                ps=self.ctx.kec_ps(),
                                dev_mode=self.ctx.dev_mode,
                                device=self.ctx.device)
        self.ctx.hot.set(hs.keccak_receipt_key(job, d["out"]), r)
        if self.ctx.coproc_succinct is not None and pre_chain is not None:
            sr = self.ctx.coproc_succinct.lift(r, pre_chain=pre_chain,
                                               pre_count=pre_count)
            self.ctx.hot.set(hs.coproc_succ_key(job, d["out"]), sr)
        return dict(perms=r.count), [hs.coproc_state_key(job, d["claim"])]

    def _task_resolve(self, task):
        d = task.definition
        job = task.job_id
        root = self.ctx.hot.get(hs.recursion_receipt_key(job, d["root"]))
        if root is None:
            raise RuntimeError("resolve: root receipt missing")
        # coprocessor merge (reference resolve.rs:63-100): the proven
        # union must cover every keccak claim the guest ecalled, and the
        # union's batch proofs must verify
        if d.get("coproc_root"):
            from ..zkvm import coproc

            u = self.ctx.hot.get(hs.keccak_receipt_key(
                job, d["coproc_root"]))
            if u is None:
                raise RuntimeError("resolve: coproc union receipt missing")
            if not coproc.verify_union(u, self.ctx.kec_ps(),
                                       dev_mode=self.ctx.dev_mode):
                raise RuntimeError("resolve: coproc union failed to verify")
            proven = set(x.hex() for x in u.digests())
            missing = [h for h in d.get("keccak_claims", [])
                       if h not in proven]
            if missing:
                raise RuntimeError(
                    f"resolve: {len(missing)} keccak claims unproven")
            self.ctx.store.put("receipts/coproc", job, u)
            if self.ctx.coproc_succinct is not None:
                from ..recursion import claims as rclaims
                from ..recursion import coproc_succinct as rcs

                us = self.ctx.hot.get(hs.coproc_succ_key(
                    job, d["coproc_root"]))
                if us is not None:
                    if not self.ctx.coproc_succinct.verify(us):
                        raise RuntimeError(
                            "resolve: succinct coproc union invalid")
                    # the union claim's span must be exactly the guest's
                    # ecall chain (genesis -> fold of keccak_claims)
                    chain = rclaims.ZERO_CHAIN
                    for h in d.get("keccak_claims", []):
                        chain = rcs.chain_step(
                            chain,
                            rclaims.digest_from_bytes(bytes.fromhex(h)))
                    if (us.claim.pre_chain != rclaims.ZERO_CHAIN
                            or us.claim.post_chain != chain):
                        raise RuntimeError(
                            "resolve: succinct coproc chain mismatch")
                    self.ctx.store.put("receipts/coproc_succ", job, us)
                    # in-circuit discharge: resolve_coproc verifies the
                    # union receipt inside the main lattice and resets
                    # the claim's coproc chain (the host checks above
                    # are a fast-fail; the math is the binding)
                    ssys = self.ctx.succinct_sys()
                    if (ssys is not None
                            and hasattr(ssys, "resolve_coproc")
                            and (getattr(ssys, "coproc_sys", True)
                                 is not None)):
                        root = ssys.resolve_coproc(root, us)
            elif self.ctx.dev_mode and d.get("keccak_claims"):
                # dev mode without a succinct coproc lattice: the v1
                # union `u` was host-verified above; synthesize its span
                # claim and discharge (claim math identical, no proof)
                from ..recursion import claims as rclaims
                from ..recursion import coproc_succinct as rcs

                digests = [rclaims.digest_from_bytes(bytes.fromhex(h))
                           for h in d["keccak_claims"]]
                chain = rclaims.ZERO_CHAIN
                for dg in digests:
                    chain = rcs.chain_step(chain, dg)
                span = rcs.CoprocClaim(
                    circuit_id=(0,) * 8, pre_chain=rclaims.ZERO_CHAIN,
                    post_chain=chain, pre_count=0,
                    post_count=len(digests))
                ssys = self.ctx.succinct_sys()
                if ssys is not None and hasattr(ssys, "resolve_coproc"):
                    root = ssys.resolve_coproc(root, _DevUnion(span))
        if self.ctx.succinct_sys() is not None:
            resolved = self._succinct_resolve(root, d)
            claim_hex = claims.digest_bytes(resolved.claim.digest()).hex()
        else:
            assumptions = []
            for digest in root.claim.assumption_digests():
                r = self.ctx.hot.get(hs.receipt_key(digest.hex()))
                if r is None:
                    raise RuntimeError(
                        "resolve: no receipt for assumption "
                        f"{digest.hex()[:16]}")
                assumptions.append(r)
            resolved = rec.resolve(root, assumptions) if assumptions else root
            claim_hex = resolved.claim_digest().hex()
        self.ctx.hot.set(hs.recursion_receipt_key(job, "resolved"), resolved)
        return dict(claim=claim_hex), \
            [hs.recursion_receipt_key(job, d["root"])]

    def _succinct_resolve(self, root, d):
        """Pop every assumption in reverse VERIFY order (each pop is one
        resolve program run; reference resolve.rs:85 iterates the same
        way over the union + assumption receipts)."""
        digests = [claims.digest_from_bytes(bytes.fromhex(h))
                   for h in d.get("assumptions", [])]
        if not digests:
            return root
        prefixes = claims.assumption_chain_prefixes(
            root.claim.pre_assumptions, digests)
        cur = root
        for dt, prev in reversed(list(zip(digests, prefixes))):
            key = hs.receipt_key(claims.digest_bytes(dt).hex())
            a = self.ctx.hot.get(key)
            if a is None:
                raise RuntimeError(
                    "resolve: no receipt for assumption "
                    f"{claims.digest_bytes(dt).hex()[:16]}")
            cur = self.ctx.succinct_sys().resolve(cur, a, prev)
        return cur

    # --- finalize ------------------------------------------------------
    def _task_finalize(self, task):
        d = task.definition
        job = task.job_id
        root = self.ctx.hot.get(hs.recursion_receipt_key(job, "resolved"))
        if root is None:
            raise RuntimeError("finalize: resolved receipt missing")
        image = self.ctx.store.get("elfs", d["image_id"])
        if self.ctx.succinct_sys() is not None:
            stats = self.ctx.hot.get(hs.exec_stats_key(job)) or {}
            jb = stats.get("journal", b"")
            words = [int.from_bytes(jb[i : i + 4], "little")
                     for i in range(0, len(jb), 4)]
            from ..zkvm import paging

            mem_anchor = paging.image_root(image)
            session = succinct.finalize_session(root, words,
                                                entry_pc=image.entry,
                                                image_mem_root=mem_anchor)
            if not succinct.verify_session(session, self.ctx.succinct_sys(),
                                           expected_mem_root=mem_anchor):
                raise RuntimeError(
                    "finalize: session receipt failed verification")
            claim_hex = claims.digest_bytes(root.claim.digest()).hex()
        else:
            from ..zkvm import paging

            session = rec.SessionReceipt.finalize(
                root, entry_pc=image.entry,
                image_mem_root=paging.image_root(image))
            if not session.verify(ps=self.ctx.ps, image=image):
                raise RuntimeError(
                    "finalize: session receipt failed verification")
            claim_hex = root.claim_digest().hex()
        self.ctx.store.put("receipts/stark", job, session)
        # publish by claim digest for composition consumers
        self.ctx.hot.set(hs.receipt_key(claim_hex), root)
        return dict(journal=session.journal.hex()), [
            hs.recursion_receipt_key(job, "resolved")]

    # --- snark (stark -> groth16 wrap) ---------------------------------
    def _task_snark(self, task):
        from ..groth16 import wrap as g16wrap

        d = task.definition
        session = self.ctx.store.get("receipts/stark", d["source_job"])
        if session is None:
            raise RuntimeError("snark: missing stark receipt")
        wrapped = g16wrap.compress(session, kind=d.get("compress", "groth16"),
                                   system=self.ctx.succinct_sys())
        bucket = ("receipts/groth16" if d.get("compress") != "blake3_groth16"
                  else "receipts/blake3_groth16")
        self.ctx.store.put(bucket, task.job_id, wrapped)
        return dict(ok=True), []


def _fwd(d):
    """Definition fields forwarded from exec to downstream tasks."""
    return dict(image_id=d["image_id"])


def _segment_pre_chains(ex, result):
    """Per-segment pre-chains: {seg index: {tag: [8 ints]}} — prefix folds
    of the session's journal / input / verify word streams at each
    segment's pre_seqs counters, plus the keccak coproc chain (tag 8:
    per-permutation digest folds at the segment's cpio counter). JSON-
    safe for task definitions."""
    streams = {4: [int(w) for w in ex.journal_words],
               5: [int(w) for w in ex.input_words],
               6: [int(w) for w in ex.verify_words]}
    seq_key = {4: "commit", 5: "read", 6: "verify"}
    perm_digests = [claims.digest_from_bytes(d) for d in ex.keccak_claims]
    out = {}
    chain = {t: claims.ZERO_CHAIN for t in claims.CHAIN_TAGS}
    cp_chain = claims.ZERO_CHAIN
    pos = {t: 0 for t in claims.CHAIN_TAGS}
    cp_pos = 0
    for seg in result.segments:
        for t in claims.CHAIN_TAGS:
            upto = int(seg.pre_seqs[seq_key[t]])
            if upto > pos[t]:
                chain[t] = claims.fold_words(
                    chain[t], streams[t][pos[t] : upto])
                pos[t] = upto
        upto_p = int(seg.pre_seqs.get("cpio", 0)) // 100
        while cp_pos < upto_p:
            cp_chain = claims.coproc_fold_step(cp_chain,
                                               perm_digests[cp_pos])
            cp_pos += 1
        enc = {str(t): [int(x) for x in chain[t]]
               for t in claims.CHAIN_TAGS}
        enc[str(claims.COPROC_TAG)] = [int(x) for x in cp_chain]
        out[seg.index] = enc
    return out


def _decode_chains(enc):
    """Inverse of the _segment_pre_chains per-segment encoding."""
    return {int(t): tuple(int(x) for x in v) for t, v in enc.items()}


@dataclasses.dataclass
class _DevUnion:
    """Span-claim carrier for the dev-mode coproc discharge."""

    claim: object


def run_workers(ctx: ClusterContext, counts: dict, idle_timeout=None):
    """Spawn worker threads per stream; returns (threads, agents)."""
    agents, threads = [], []
    for stream, n in counts.items():
        for i in range(n):
            a = Agent(ctx, stream, f"{stream}-{i}")
            t = threading.Thread(target=a.poll_work, args=(idle_timeout,),
                                 daemon=True)
            t.start()
            agents.append(a)
            threads.append(t)
    return threads, agents
