"""Mean wall seconds of a recursion lift (`SuccinctSystem.lift`: the
lift program's native evaluation and its RecursionAir proof), from a span
the benchmark puts around the call, stopped after the card finishes."""

NAME = "lift_s"
SPANS = [("boundless_tpu_torch.recursion.succinct", "SuccinctSystem.lift",
          "lift_sync", {"sync": True})]


def read(trace):
    calls = trace.spans.get("lift_sync", [])
    return sum(calls) / len(calls) if calls else None
