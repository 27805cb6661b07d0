"""boundless-tpu-torch CLI: the subcommands of the proving cluster and the
requestor.

The port's copy of the cluster and requestor parts of `boundless_tpu/cli.py`
(reference `boundless` binary, `crates/boundless-cli`): `prover execute`
(preflight), `cluster serve` (API + workers in one process), `cluster
worker` (an HTTP-attached worker process), `cluster dataplane` (the shared
taskdb/hot-store server) and `requestor submit` (one signed request through
a local market and a dev-mode broker) — `python -m boundless_tpu_torch.cli
<group> <cmd>`. Proofs run on `--device` (the card unless asked for the
CPU).
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="boundless-tpu-torch")
    sub = p.add_subparsers(dest="group", required=True)

    prover = sub.add_parser("prover").add_subparsers(dest="cmd", required=True)
    ex = prover.add_parser("execute")
    ex.add_argument("image")
    ex.add_argument("--input", default="")
    ex.add_argument("--po2", type=int, default=14)
    ex.set_defaults(fn=cmd_prover_execute)

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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
