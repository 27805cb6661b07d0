"""Mean seconds of a proof's commit stage: inside `stark.prove`, the
control and data LDE commits (each group interpolated, extended to the 4N
coset and its rows leaf-hashed into a Merkle tree), stopped after the card
finishes; every proof in the window. In an rv32im segment of po2 20 the
data LDE is 2^22 x 584 words, the largest tensor of the proof. Read from
the port's own span `stark.commit` (`span_seconds{span="stark.commit"}`)."""

from proofbench import program_spans

NAME = "commit_s"
program_spans.enable_tracer()


def read(trace):
    return program_spans.registry_mean(trace, "span_seconds",
                                       span="stark.commit")
