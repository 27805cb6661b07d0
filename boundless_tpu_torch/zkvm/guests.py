"""Guest programs for the port: the JAX package's `zkvm/guests.py`.

That module assembles rv32im guests with `zkvm/asm.py` and imports only
`asm`, `isa` and the executor's `MemoryImage`, none of which reaches
`jax`; it is re-exported here so callers of the port import guests from
`boundless_tpu_torch` alone.
"""

from boundless_tpu.zkvm.guests import (  # noqa: F401 (re-exported)
    assessor, auipc_guest, build, echo, identity, keccak_guest, loop_guest,
    memtest, muldiv, signed_m_guest, subword_guest, words)
