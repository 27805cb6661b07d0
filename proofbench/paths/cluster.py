"""The cluster path: Bento's full job to a succinct STARK receipt.

Set-up builds the recursion lattice (`recursion.succinct.SuccinctSystem`),
a cluster context with its stores (the object store under `TMPDIR`), the
REST API on localhost (`cluster.api`) and the worker threads
(`cluster.agent.run_workers`), and uploads the program. Each job is one
session through `BentoClient`: upload the input, create the session, wait
for SUCCEEDED, download `/receipts/stark/<job>`.
"""

from __future__ import annotations

import shutil
import tempfile

import torch

POLL_S = 0.05
SESSION_TIMEOUT_S = 300.0


class Path:
    def __init__(self, config: dict, device, rec_proof_system=None):
        from boundless_tpu_torch.cluster.agent import (ClusterContext,
                                                       run_workers)
        from boundless_tpu_torch.cluster.api import (BentoClient, ClusterApi,
                                                     make_http_server)
        from boundless_tpu_torch.cluster.hotstore import HotStore
        from boundless_tpu_torch.cluster.storage import SharedFs
        from boundless_tpu_torch.cluster.taskdb import MemoryBackend
        from boundless_tpu_torch.prover import stark
        from boundless_tpu_torch.recursion import succinct
        from boundless_tpu_torch.zkvm.executor import MemoryImage

        prog = config["program"]
        rec = config["recursion"]
        self.device = torch.device(device)
        self.po2 = config["segment_po2"]
        ps = stark.ProofSystem(**config["proof_system"])
        # `rec_proof_system` replaces the lattice's (the control)
        rec_ps = stark.ProofSystem(**(rec_proof_system
                                      or rec["proof_system"]))
        self.system = succinct.SuccinctSystem(succinct.SuccinctParams(
            self.po2, ps, rec["rec_po2"], rec_ps, tuple(rec["variants"])),
            device=self.device)
        self.store_dir = tempfile.mkdtemp(prefix="proofbench-store-")
        ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(),
                             store=SharedFs(self.store_dir), ps=ps,
                             segment_po2=self.po2, device=str(self.device),
                             succinct=self.system)
        self.server, thread = make_http_server(ClusterApi(ctx))
        thread.start()
        self.client = BentoClient(
            f"http://127.0.0.1:{self.server.server_address[1]}")
        self.threads, self.agents = run_workers(ctx, config["pools"])
        self.image = MemoryImage.from_words(prog["words"], prog["base"],
                                            prog["entry"])
        self.client.upload_image("guest", self.image)

    def run_job(self, job) -> dict:
        from boundless_tpu_torch.zkvm import guests

        from proofbench.harness import JobFailed

        input_id = f"input-{job.index}"
        self.client.upload_input(input_id, guests.words(job.input_words))
        uuid = self.client.create_session("guest", input_id,
                                          segment_po2=self.po2)
        st = self.client.wait(uuid, timeout=SESSION_TIMEOUT_S, poll=POLL_S)
        if st["status"] != "SUCCEEDED":
            raise JobFailed(f"session {uuid} {st['status']}: "
                            f"{st.get('error_msg')}")
        data = self.client._req("GET", f"/receipts/stark/{uuid}")
        return dict(cycles=int(st["stats"]["total_cycles"]),
                    inputs=list(job.input_words), receipt=data,
                    stats=st["stats"])

    @staticmethod
    def export(output: dict) -> dict:
        """What the reference judges: the downloaded receipt's fields."""
        import dataclasses

        from boundless_tpu_torch.utils import serde

        s = serde.load_session_receipt(output["receipt"], "cpu")
        claim = {f.name: getattr(s.root.claim, f.name)
                 for f in dataclasses.fields(s.root.claim)}
        return dict(
            kind="session", inputs=output["inputs"], stats=output["stats"],
            journal=s.journal, image_id=[int(x) for x in s.image_id],
            entry_pc=int(s.entry_pc), root_kind=s.root.kind,
            root_proof=s.root.proof, root_claim=claim,
            root_pub=[int(x) for x in s.root.pub_vals],
            root_po2=int(s.root.po2))

    def close(self):
        for a in self.agents:
            a.stop()
        for t in self.threads:
            t.join(timeout=60)
        self.server.shutdown()
        self.server.server_close()
        shutil.rmtree(self.store_dir, ignore_errors=True)
