"""Mean seconds of a segment's STARK (`prover.stark.prove` called from
`zkvm.prove.prove_segment`; the recursion's own proofs are left out),
from a span the benchmark puts around the call, stopped after the card
finishes."""

NAME = "stark_s"
SPANS = [("boundless_tpu_torch.zkvm.prove", "prove_segment",
          "prove_segment", {}),
         ("boundless_tpu_torch.prover.stark", "prove", "segment_stark",
          {"inside": "prove_segment", "sync": True})]


def read(trace):
    calls = trace.spans.get("segment_stark", [])
    return sum(calls) / len(calls) if calls else None
