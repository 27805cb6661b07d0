"""Object storage: cold artifact plane (SharedFs layout).

Mirrors the reference's `SharedFs` object store and bucket layout
(`prover/crates/workflow-common/src/storage.rs:16-56`): elfs/, inputs/,
exec_logs/, receipts/{stark,groth16,blake3_groth16}/, preflight_journals/,
work_receipts/. Pickle is the v1 wire format (bincode-compatible C++
serialization is staged work, SURVEY.md §2.4c).

The port's copy of `boundless_tpu/cluster/storage.py`. Torch pickles a
tensor with its device, so `put` moves every tensor of an object to the
CPU first (`utils/serde.to_cpu`): a file written on the card loads in a
process without one. Each write has a temporary file of its own, so
writers of one key never share one.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
import uuid

from ..utils.serde import to_cpu

BUCKETS = ("elfs", "inputs", "exec_logs", "preflight_journals",
           "receipts/stark", "receipts/groth16", "receipts/blake3_groth16",
           "work_receipts")


class SharedFs:
    def __init__(self, root: str = None):
        self.root = root or tempfile.mkdtemp(prefix="boundless_tpu_store_")
        self._lock = threading.Lock()
        for b in BUCKETS:
            os.makedirs(os.path.join(self.root, b), exist_ok=True)

    def _path(self, bucket: str, key: str) -> str:
        assert ".." not in key
        return os.path.join(self.root, bucket, key)

    def _publish(self, bucket: str, key: str, write):
        """Write through a temporary file of this call's own and rename it
        into place (atomic publish). The reference names the temporary
        `<path>.tmp`, so two writers of one key (the broker's preflight
        and prove both upload the order's image) share it, and the later
        rename finds it gone."""
        path = self._path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)

    def put(self, bucket: str, key: str, obj):
        self._publish(bucket, key, lambda f: pickle.dump(to_cpu(obj), f))

    def put_bytes(self, bucket: str, key: str, data: bytes):
        self._publish(bucket, key, lambda f: f.write(data))

    def get(self, bucket: str, key: str):
        path = self._path(bucket, key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def get_bytes(self, bucket: str, key: str):
        path = self._path(bucket, key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def exists(self, bucket: str, key: str) -> bool:
        return os.path.exists(self._path(bucket, key))

    def delete(self, bucket: str, key: str):
        try:
            os.remove(self._path(bucket, key))
        except FileNotFoundError:
            pass
