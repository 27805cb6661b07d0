"""Mean host seconds of a segment's witness (`zkvm.prove._gen_witness`:
the C++ cycle loop and the Python tail that builds the data trace and the
public values), from a span the benchmark puts around the call."""

NAME = "witness_s"
SPANS = [("boundless_tpu_torch.zkvm.prove", "_gen_witness", "witness", {})]


def read(trace):
    calls = trace.spans.get("witness", [])
    return sum(calls) / len(calls) if calls else None
