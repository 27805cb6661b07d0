"""Broker -> proving-cluster adapter.

The port's copy of `boundless_tpu/market/broker/cluster_prover.py`.

Re-design of the reference's Bonsai prover adapter
(`crates/risc0-backend/src/provers/bonsai.rs:400`): implements the broker's
prover duck-type (preflight / prove) by driving the cluster REST surface —
upload image+input, create session, poll, fetch the session receipt.
`prove` returns (journal, SessionReceipt seal, claim digest), so market
verifiers can fully verify the STARK.
"""

from __future__ import annotations

import time


class ClusterProver:
    """Drives an in-process ClusterApi. A BentoClient over HTTP does not
    fit, as in the reference: its upload_image takes an image where
    ClusterApi's takes bytes, its create_session takes positional ids
    where ClusterApi's takes a dict, and it has no receipt_obj."""

    def __init__(self, api, poll: float = 0.1, timeout: float = 1800.0):
        self.api = api
        self.poll = poll
        self.timeout = timeout

    def _ids_for(self, image, input_data):
        from ...utils import serde

        image_id = image.image_id().hex()
        input_id = f"in-{hash((image_id, input_data)) & 0xFFFFFFFF:x}"
        self.api.upload_image(image_id, serde.dump_image(image))
        self.api.upload_input(input_id, input_data)
        return image_id, input_id

    def _wait(self, job_id):
        deadline = time.time() + self.timeout
        while time.time() < deadline:
            st = self.api.session_status(job_id)
            if st["status"] == "SUCCEEDED":
                return st
            if st["status"] == "FAILED":
                raise RuntimeError(f"cluster job failed: {st.get('error_msg')}")
            time.sleep(self.poll)
        raise TimeoutError(f"cluster job {job_id} timed out")

    def preflight(self, image, input_data) -> int:
        image_id, input_id = self._ids_for(image, input_data)
        job = self.api.create_session(dict(img=image_id, input=input_id,
                                           execute_only=True))["uuid"]
        st = self._wait(job)
        return int(st["stats"]["total_cycles"])

    def prove(self, image, input_data):
        image_id, input_id = self._ids_for(image, input_data)
        job = self.api.create_session(dict(img=image_id,
                                           input=input_id))["uuid"]
        self._wait(job)
        session = self.api.receipt_obj(job)
        if session is None:
            raise RuntimeError("cluster session receipt missing")
        return (session.journal, session,
                session.root.claim_digest())


def session_seal_verifier(ps=None, device="cuda"):
    """Market verifier callback for SessionReceipt seals, verified on
    `device` (the card unless the caller asks for the CPU): the cluster's
    object store holds host tensors, so the seal moves there first. A CUDA
    device without a card raises here."""
    from ...recursion.receipt import SessionReceipt
    from ...utils import serde
    from ...zkvm.prove import _device

    dev = _device(device)

    def verify(fill, request):
        seal = fill.seal

        if not isinstance(seal, SessionReceipt):
            return False
        if seal.journal != fill.journal:
            return False
        expected = bytes.fromhex(request.requirements.image_id)
        # image binding: proof-level image id travels in the claim; the
        # request's image_id is the executor-level digest — bind via the
        # image the request shipped (preflight recomputes and compares).
        return serde.to_device(seal, dev).verify(ps=ps)

    return verify
