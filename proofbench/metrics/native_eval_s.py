"""Mean seconds of a recursion proof's data trace
(`recursion.air.data_trace`: the program's native evaluation and its
host conversion, the stage `SuccinctSystem` times as `native_eval`), from
a span the benchmark puts around the call, stopped after the card
finishes."""

NAME = "native_eval_s"
SPANS = [("boundless_tpu_torch.recursion.air", "data_trace",
          "native_eval_sync", {"sync": True})]


def read(trace):
    calls = trace.spans.get("native_eval_sync", [])
    return sum(calls) / len(calls) if calls else None
