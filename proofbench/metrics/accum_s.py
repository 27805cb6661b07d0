"""Mean seconds of a proof's accumulator stage: inside `stark.prove`, the
mix challenges, `air.accum_trace` (its int64 prefix sum) and the
accumulator's LDE commit, stopped after the card finishes; every proof in
the window (segments, lifts and joins alike). Read from the port's own
span `stark.accum` (`span_seconds{span="stark.accum"}`)."""

from proofbench import program_spans

NAME = "accum_s"
program_spans.enable_tracer()


def read(trace):
    return program_spans.registry_mean(trace, "span_seconds",
                                       span="stark.accum")
