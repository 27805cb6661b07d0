"""boundless-tpu-torch CLI: the subcommands of the proving cluster and the
requestor.

The port's copy of `boundless_tpu/cli.py` (reference `boundless` binary,
`crates/boundless-cli`): `prover execute` (preflight), `prover
generate-config` (the config wizard), `prover audit-degrees` (the
constraint-degree audit), `prover bootstrap-verifier` (the on-chain
verifier artifacts), `cluster serve` (API + workers in one process),
`cluster worker` (an HTTP-attached worker process), `cluster dataplane`
(the shared taskdb/hot-store server), `requestor submit` (one signed
request through a local market and a dev-mode broker) and `rewards
emissions` / `rewards mint` (the ZKC emission split and the PoVW mints) —
`python -m boundless_tpu_torch.cli <group> <cmd>`. Proofs and audits run
on `--device` (the card unless asked for the CPU). The reference's `prover
benchmark` waits for the port's bench.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

# recursion proof size of `cluster serve` unless the config names one: the
# reference's 16 holds none of the programs at 100 queries (a q100 join is
# 1,875,554 rows); 21 holds them all
REC_PO2 = 21


def _load_image(path_or_name):
    from .zkvm import guests

    builtin = dict(echo=guests.echo, loop=guests.loop_guest,
                   identity=guests.identity, muldiv=guests.muldiv,
                   memtest=guests.memtest)
    if path_or_name in builtin:
        return builtin[path_or_name]()
    if path_or_name.endswith(".s") or path_or_name.endswith(".asm"):
        with open(path_or_name) as f:
            return guests.build(f.read())
    with open(path_or_name, "rb") as f:
        return pickle.load(f)


def cmd_prover_execute(args):
    """Execute-only preflight (reference prover execute)."""
    from .zkvm.executor import Executor

    image = _load_image(args.image)
    input_bytes = bytes.fromhex(args.input) if args.input else b""
    res = Executor(image, input_bytes, segment_po2=args.po2).run()
    print(json.dumps(dict(
        total_cycles=res.total_cycles, segments=len(res.segments),
        exit_code=res.exit_code, journal=res.journal.hex(),
        image_id=res.image_id.hex())))


def cmd_prover_generate_config(args):
    """Config wizard (reference generate_config.rs): sizes segment po2 from
    the card's memory and sets one concurrent proof per card."""
    import torch

    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("generate-config reads the cards' memory and "
                           "needs a CUDA device")
    devices = [torch.cuda.get_device_name(i) for i in range(count)]
    mem_gb = min(torch.cuda.get_device_properties(i).total_memory
                 for i in range(count)) // (1 << 30)
    po2 = min(20, max(14, 17 + (mem_gb // 16)))
    print(json.dumps(dict(
        devices=devices,
        mem_gb=mem_gb,
        segment_po2=po2,
        peak_prove_khz=args.khz or 100.0,
        max_concurrent_proofs=count,
        note="the port has no `prover benchmark` yet: measure a segment's "
             "effective kHz (chip_smoke.py [main]) and set peak_prove_khz "
             "= 0.75 * effective_khz",
    )))


def rv32im_audit_pub(rng, device):
    """Random rv32im PublicValues for the degree audit: uniform words in
    [0, P) drawn field by field in declaration order (the reference
    CLI's draws, so the audit sees the same constants)."""
    import numpy as np
    import torch

    from .air import rv32im as R
    from .core import field as F

    def rf(shape):
        words = rng.integers(0, F.P, size=shape, dtype=np.uint32)
        return torch.from_numpy(words.astype(np.int32)).to(device)

    return R.PublicValues(
        pre_pc=rf(()), post_pc=rf(()), pre_regs=rf((64,)),
        post_regs=rf((64,)), halted=rf(()), pre_seqs=rf((4,)),
        post_seqs=rf((4,)), io=rf((R.IO_MAX, 5)), cpio=rf((R.CP_IO, 4)),
        mem=rf((R.MEM_PAGES, R.MEM_PAGE_ELEMS)))


def cmd_prover_audit_degrees(args):
    """Constraint-degree audit of the rv32im AIR (air/degree.py) on
    `--device`.

    The dev gate for any AIR change: fails if any constraint exceeds the
    declared max_degree or the hard composition-split budget.
    """
    import numpy as np

    from .air import degree as DA
    from .air import rv32im as R

    pub = rv32im_audit_pub(np.random.default_rng(0), args.device)
    for air in (R.Rv32imAir(), R.Rv32imAir(False)):
        degs = DA.assert_degrees(air, pub, po2=args.po2, device=args.device)
        n = 1 << args.po2
        worst = max(d.degree for d in degs)
        print(json.dumps(dict(
            air=air.name, constraints=len(degs), po2=args.po2,
            worst_degree=worst, worst_mult=round(worst / (n - 1), 3),
            declared=air.max_degree, budget=DA.degree_budget(args.po2),
            ok=True)))


def cmd_prover_bootstrap_verifier(args):
    """Generate the on-chain verifier artifacts (xtask bootstrap role:
    reference `xtask/src/bootstrap_blake3_groth16.rs:43-46` regenerating
    contracts/src/blake3-groth16/*.sol).

    Builds the recursion system and identity_p254 on `--device` (their
    control IDs run the Poseidon2 and p254 sponges), the wrap circuit's
    layout for them, a DETERMINISTIC dev CRS (--seed; a production
    deployment substitutes the ceremony CRS), and writes
    Groth16Verifier.sol with the verifying key and the allowed-set control
    root baked in, and bootstrap.json, into --out. The layout and the
    set-up are host work (minutes at CI scale)."""
    import random

    from .core import poseidon_bn254 as P254
    from .groth16 import circuit as C
    from .groth16 import evm, qap, r1cs
    from .prover import stark
    from .recursion import air as rair
    from .recursion import identity, succinct

    seconds = {}
    t0 = time.perf_counter()
    ps = stark.ProofSystem(queries=args.queries, fri_min_degree=16,
                           commit_expand=2)
    params = succinct.SuccinctParams(seg_po2=args.seg_po2, seg_ps=ps,
                                     rec_po2=args.rec_po2, rec_ps=ps)
    system = succinct.get_system(params, device=args.device)
    seconds["recursion_system"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p254 = identity.get_p254(system)
    seconds["identity_p254"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bld = r1cs.Builder(concrete=False)
    C.build_verifier(bld, rair.AIR, p254.po2, p254.ps254,
                     p254.control_id, proof=None, pub_vals=None)
    sys_ = bld.to_sparse()
    seconds["layout"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = random.Random(args.seed)
    _td, vk = qap.setup_trapdoor(sys_, rng=lambda n: rng.randrange(1, n))
    seconds["setup"] = time.perf_counter() - t0
    root_felt = P254.pack_bb([int(x) for x in system.allowed_root])
    src = evm.generate_verifier(vk, allowed_root_felt=int(root_felt))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "Groth16Verifier.sol")
    with open(path, "w") as f:
        f.write(src)
    meta = dict(seg_po2=args.seg_po2, rec_po2=args.rec_po2,
                queries=args.queries, seed=args.seed,
                n_rows=len(sys_.rows), n_vars=sys_.n_vars,
                control_root_felt=str(int(root_felt)),
                allowed_root=[int(x) for x in system.allowed_root])
    with open(os.path.join(args.out, "bootstrap.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(dict(wrote=path, **meta)))
    print(json.dumps(dict(device=str(system.device), seconds={
        k: round(v, 3) for k, v in seconds.items()})))


def cmd_cluster_serve(args):
    """Run an in-process cluster (API + workers) — reference compose.yml."""
    from .cluster.agent import ClusterContext, run_workers
    from .cluster.api import ClusterApi, make_http_server
    from .cluster.hotstore import HotStore
    from .cluster.storage import SharedFs
    from .cluster.taskdb import MemoryBackend
    from .prover import stark

    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    pools = cfg.get("workers", {"exec": args.exec_workers,
                                "prove": args.prove_workers,
                                "join": 1, "aux": 1, "snark": 1})
    ps_cfg = cfg.get("proof_system", {})
    ps = stark.ProofSystem(
        queries=int(ps_cfg.get("queries", 100)),
        fri_min_degree=int(ps_cfg.get("fri_min_degree", 256)),
        commit_expand=int(ps_cfg.get("commit_expand", 2)))
    device = cfg.get("device", args.device)
    # Succinct recursion is the default serving mode (constant-size
    # receipts; reference clusters always lift+join, prove.rs:68-95).
    mode = cfg.get("succinct", getattr(args, "succinct", "real"))
    system, dev_mode = None, False
    if mode == "real":
        from .recursion import succinct as S

        rec_cfg = cfg.get("recursion", {})
        rec_ps = stark.ProofSystem(
            queries=int(rec_cfg.get("queries", ps.queries)),
            fri_min_degree=int(rec_cfg.get("fri_min_degree",
                                           ps.fri_min_degree)),
            commit_expand=int(rec_cfg.get("commit_expand",
                                          ps.commit_expand)))
        system = S.get_system(S.SuccinctParams(
            seg_po2=int(cfg.get("segment_po2", args.po2)), seg_ps=ps,
            rec_po2=int(rec_cfg.get("rec_po2", REC_PO2)),
            rec_ps=rec_ps), device=device)
    elif mode == "dev":
        from .recursion import succinct as S

        system, dev_mode = S.DevModeSystem(), True
    dp_addr = cfg.get("dataplane") or getattr(args, "dataplane", None)
    if dp_addr:  # shared multi-host substrate (cluster/dataplane.py)
        from .cluster.dataplane import connect as dp_connect

        host_, _, port_ = str(dp_addr).rpartition(":")
        db_, hot_ = dp_connect((host_ or "127.0.0.1", int(port_)))
    else:
        db_ = MemoryBackend()
        hot_ = HotStore(float(cfg.get("hot_store_ttl_secs", 28800)))
    ctx = ClusterContext(
        db=db_,
        hot=hot_,
        store=SharedFs(cfg.get("storage_root") or args.storage),
        ps=ps,
        segment_po2=int(cfg.get("segment_po2", args.po2)),
        succinct=system, dev_mode=dev_mode, device=device)
    api = ClusterApi(ctx)
    port = int(cfg.get("api", {}).get("port", args.port))
    host = cfg.get("api", {}).get("host", getattr(args, "host", "127.0.0.1"))
    token = (getattr(args, "token", None)
             or cfg.get("api", {}).get("token")
             or os.environ.get("BT_CLUSTER_TOKEN"))
    server, thread = make_http_server(api, host=host, port=port, token=token)
    thread.start()
    run_workers(ctx, pools)
    print(f"cluster API on http://127.0.0.1:{server.server_address[1]} "
          f"(storage: {ctx.store.root}, pools: {pools}, device: {device})",
          flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        server.shutdown()


def cmd_cluster_worker(args):
    """Attach a worker to a remote cluster API over HTTP."""
    from .cluster.remote import worker_main

    argv = ["--api-url", args.api_url, "--stream", args.stream,
            "--device", args.device]
    if args.worker_id:
        argv += ["--worker-id", args.worker_id]
    if getattr(args, "token", None):
        argv += ["--token", args.token]
    if args.idle_timeout is not None:
        argv += ["--idle-timeout", str(args.idle_timeout)]
    worker_main(argv)


def cmd_cluster_dataplane(args):
    """Standalone taskdb/hot-store server (cluster/dataplane.py)."""
    from .cluster.dataplane import main as dataplane_main

    dataplane_main(["--host", args.host, "--port", str(args.port)]
                   + (["--sqlite", args.sqlite] if args.sqlite else []))


def cmd_requestor_submit(args):
    """One-shot requestor flow against a local market + broker
    (reference `boundless requestor submit` / submit-file,
    `crates/boundless-cli/src/commands/requestor/mod.rs:62`): build the
    request with the layered builder, submit on-chain, let a dev-mode
    broker price/lock/prove/fulfill, print (journal, seal)."""
    import hashlib

    from .cluster.storage import SharedFs
    from .market.broker.pipeline import Broker, BrokerConfig
    from .market.chain import MarketChain
    from .market.client import Client, LocalStorageProvider
    from .market.crypto import Wallet
    from .zkvm import guests
    from .zkvm.executor import Executor

    class DevProver:
        def preflight(self, image, input_data):
            return Executor(image, input_data).run().total_cycles

        def prove(self, image, input_data):
            res = Executor(image, input_data).run()
            seal = {"dev_mode": True, "journal": res.journal,
                    "image_id": res.image_id.hex()}
            return (res.journal, seal,
                    hashlib.sha256(res.journal).digest())

    def verifier(fill, req):
        return (fill.seal.get("dev_mode")
                and fill.seal["journal"] == fill.journal
                and fill.seal["image_id"] == req.requirements.image_id)

    image = _load_image(args.image)
    payload = [int(x) for x in args.input.split(",")] if args.input else []
    chain = MarketChain(verifier)
    wallet = Wallet.from_seed((args.key or "requestor").encode())
    chain.create_account(wallet.address, funds=10**9)
    chain.create_account("prover-node", funds=10**7)
    chain.deposit_collateral("prover-node", 10**6)
    provider = LocalStorageProvider(SharedFs())
    client = Client(chain, wallet, storage_provider=provider)
    broker = Broker(chain, DevProver(), "prover-node",
                    BrokerConfig(min_mcycle_price=0), storage=provider)
    broker.start()
    try:
        req = client.build_request(image, guests.words(payload))
        print(f"request {req.id.encoded()}: auction "
              f"{req.offer.min_price}..{req.offer.max_price} wei")
        rid = client.submit_onchain(req)
        journal, seal = client.wait_for_fulfillment(
            rid, timeout=args.timeout)
        print(f"status: {chain.request_status(rid)}")
        print(f"journal: {journal.hex()}")
        print(f"seal: dev_mode={seal.get('dev_mode')} "
              f"image_id={seal.get('image_id')}")
    finally:
        broker.stop()


def cmd_rewards_emissions(args):
    """Per-epoch ZKC emission split (reference `boundless rewards`
    commands, `crates/boundless-cli/src/commands/rewards/mod.rs:78`;
    IZKC.getEmissionsForEpoch)."""
    from .market.povw import EmissionSchedule

    sched = EmissionSchedule()
    for ep in range(args.epoch, args.epoch + args.count):
        total = sched.emissions_for_epoch(ep)
        print(json.dumps(dict(epoch=ep, total=total,
                              povw=sched.povw_emissions(ep),
                              staking=sched.staking_emissions(ep))))


def cmd_rewards_mint(args):
    """Compute per-prover PoVW mints for an epoch from a work-log JSON
    file ([{prover, cycles, claim_digest}, ...] — the role of the
    reference mint-calculator guest over a posted work log)."""
    import hashlib

    from .market.povw import MintCalculator, WorkLog

    with open(args.log) as f:
        entries = json.load(f)
    # entries land in the epoch named in the file (default 0); the log's
    # clock sits one epoch past the largest so every epoch is closed
    max_ep = max((int(e.get("epoch", 0)) for e in entries), default=0)
    log = WorkLog(epoch_seconds=1.0, clock=lambda: max_ep + 1)
    for e in entries:
        log.clock = lambda ep=int(e.get("epoch", 0)): ep
        log.record(e["prover"], int(e["cycles"]),
                   bytes.fromhex(e.get("claim_digest") or
                                 hashlib.sha256(json.dumps(
                                     e, sort_keys=True).encode()
                                                ).hexdigest()))
        log.clock = lambda: max_ep + 1
    mints = MintCalculator(log, epoch_reward=args.epoch_reward
                           ).mint_for_epoch(args.epoch)
    print(json.dumps(mints, indent=2, sort_keys=True))


def main(argv=None):
    p = argparse.ArgumentParser(prog="boundless-tpu-torch")
    sub = p.add_subparsers(dest="group", required=True)

    prover = sub.add_parser("prover").add_subparsers(dest="cmd", required=True)
    ex = prover.add_parser("execute")
    ex.add_argument("image")
    ex.add_argument("--input", default="")
    ex.add_argument("--po2", type=int, default=14)
    ex.set_defaults(fn=cmd_prover_execute)
    gc = prover.add_parser("generate-config")
    gc.add_argument("--khz", type=float, default=None)
    gc.set_defaults(fn=cmd_prover_generate_config)
    ad = prover.add_parser("audit-degrees")
    ad.add_argument("--po2", type=int, default=5)
    ad.add_argument("--device", default="cuda",
                    help="where the audit runs (default: the card)")
    ad.set_defaults(fn=cmd_prover_audit_degrees)
    bv = prover.add_parser("bootstrap-verifier")
    bv.add_argument("--out", default="contracts")
    bv.add_argument("--seg-po2", type=int, default=6)
    bv.add_argument("--rec-po2", type=int, default=17)
    bv.add_argument("--queries", type=int, default=2)
    bv.add_argument("--seed", type=int, default=0)
    bv.add_argument("--device", default="cuda",
                    help="where the control IDs are computed (default: "
                         "the card)")
    bv.set_defaults(fn=cmd_prover_bootstrap_verifier)

    cluster = sub.add_parser("cluster").add_subparsers(dest="cmd",
                                                       required=True)
    sv = cluster.add_parser("serve")
    sv.add_argument("--port", type=int, default=8081)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--token", default=None,
                    help="bearer token for /workers/* (required when "
                         "--host is non-loopback; default $BT_CLUSTER_TOKEN)")
    sv.add_argument("--po2", type=int, default=14)
    sv.add_argument("--exec-workers", type=int, default=2)
    sv.add_argument("--prove-workers", type=int, default=1)
    sv.add_argument("--storage", default=None)
    sv.add_argument("--config", default=None,
                    help="deploy descriptor (deploy/cluster.json)")
    sv.add_argument("--dataplane", default=None,
                    help="host:port of a shared data-plane server "
                         "(cluster dataplane); N hosts share one job")
    sv.add_argument("--succinct", choices=("real", "dev", "off"),
                    default="real",
                    help="recursion mode (default: real succinct receipts)")
    sv.add_argument("--device", default="cuda",
                    help="where the workers prove (default: the card)")
    sv.set_defaults(fn=cmd_cluster_serve)

    wk = cluster.add_parser(
        "worker", help="HTTP-attached worker process (zero shared memory)")
    wk.add_argument("--api-url", required=True)
    wk.add_argument("--stream", required=True,
                    help="comma-separated subset of "
                         "exec,prove,join,coproc,snark,aux")
    wk.add_argument("--worker-id", default="")
    wk.add_argument("--token", default=None)
    wk.add_argument("--idle-timeout", type=float, default=None)
    wk.add_argument("--device", default="cuda",
                    help="where this worker proves (default: the card)")
    wk.set_defaults(fn=cmd_cluster_worker)

    dp = cluster.add_parser(
        "dataplane", help="standalone taskdb/hot-store server (the "
                          "Redis/Valkey role; N hosts share one job)")
    dp.add_argument("--host", default="127.0.0.1")
    dp.add_argument("--port", type=int, default=7350)
    dp.add_argument("--sqlite", default=None,
                    help="durable sqlite path (default: memory backend)")
    dp.set_defaults(fn=cmd_cluster_dataplane)

    requestor = sub.add_parser("requestor").add_subparsers(dest="cmd",
                                                           required=True)
    sb = requestor.add_parser("submit")
    sb.add_argument("--image", default="echo",
                    help="guest name (echo/loop/...) or image path")
    sb.add_argument("--input", default="3,11,22,33",
                    help="comma-separated input words")
    sb.add_argument("--key", default=None, help="requestor key seed")
    sb.add_argument("--timeout", type=float, default=600.0)
    sb.set_defaults(fn=cmd_requestor_submit)

    rewards = sub.add_parser("rewards").add_subparsers(dest="cmd",
                                                       required=True)
    em = rewards.add_parser("emissions")
    em.add_argument("--epoch", type=int, default=0)
    em.add_argument("--count", type=int, default=1)
    em.set_defaults(fn=cmd_rewards_emissions)
    mi = rewards.add_parser("mint")
    mi.add_argument("--log", required=True, help="work-log JSON file")
    mi.add_argument("--epoch", type=int, default=0)
    mi.add_argument("--epoch-reward", type=int, default=1_000_000)
    mi.set_defaults(fn=cmd_rewards_mint)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
