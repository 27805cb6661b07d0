"""Mean seconds of a trace handed from the host to the card: the port's
`field.upload` (the Montgomery conversion of the canonical words and the
copy, stopped after the card finishes), which takes a segment's witness
data in `prove_segment` and each recursion program's data trace. Read
from the port's own span `upload` (`span_seconds{span="upload"}`)."""

from proofbench import program_spans

NAME = "upload_s"
program_spans.enable_tracer()


def read(trace):
    return program_spans.registry_mean(trace, "span_seconds", span="upload")
