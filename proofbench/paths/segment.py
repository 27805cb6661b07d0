"""The segment path: a Bento prove task's work without the lift.

Each job executes the configuration's program on the job's input at the
configuration's segment size (the port's `zkvm.executor.Executor`) and
proves the one segment with `zkvm.prove.prove_segment` on the card.
"""

from __future__ import annotations

import torch


class Path:
    def __init__(self, config: dict, device, proof_system=None):
        from boundless_tpu_torch.prover import stark
        from boundless_tpu_torch.zkvm.executor import MemoryImage

        prog = config["program"]
        self.image = MemoryImage.from_words(prog["words"], prog["base"],
                                            prog["entry"])
        # `proof_system` replaces the configuration's (the control)
        self.ps = stark.ProofSystem(**(proof_system
                                       or config["proof_system"]))
        self.po2 = config["segment_po2"]
        self.device = torch.device(device)

    def run_job(self, job) -> dict:
        from boundless_tpu_torch.zkvm import guests, prove
        from boundless_tpu_torch.zkvm.executor import Executor

        res = Executor(self.image, guests.words(job.input_words),
                       segment_po2=self.po2).run()
        receipts = [prove.prove_segment(self.image, seg, self.ps,
                                        device=self.device)
                    for seg in res.segments]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return dict(cycles=res.total_cycles, inputs=list(job.input_words),
                    receipts=receipts, journal=res.journal,
                    exit_code=res.exit_code)

    @staticmethod
    def export(output: dict) -> dict:
        """What the reference judges, as plain values and tensors."""
        return dict(
            kind="segments", inputs=output["inputs"],
            cycles=output["cycles"], journal=output["journal"],
            exit_code=output["exit_code"],
            segments=[dict(pub=r.pub, image_id=[int(x) for x in r.image_id],
                           po2=r.po2, variant=r.variant, proof=r.proof)
                      for r in output["receipts"]])

    def close(self):
        pass
